"""Redshift-space distortions on the lightcone, as float32 tensor ops.

Equivalent of the device path of py21cmfast_tpu/rsds.py (reference
rsds.py:16-266): the velocity-gradient correction to tau_21 / the brightness
temperature, and the sub-cell CIC shift of cells along the line of sight (the
last axis of the cone).  Inputs are tensors; a numpy input becomes a float32
tensor on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device, to_device
from .inputs import InputParameters

__all__ = ["include_dvdr_in_tau21", "apply_rsds", "rsds_shift"]

# scratch memory of one sightline chunk of apply_rsds: its fine-grid
# temporaries take about this many bytes per fine cell (displacement,
# position, fraction, two weights and the accumulator in float32, two int64
# indices), and a chunk holds at most _RSD_CHUNK_BYTES of them
_RSD_BYTES_PER_FINE_CELL = 48
_RSD_CHUNK_BYTES = 2 * 2**30


def _hubble_of_z(inputs: InputParameters, redshifts):
    return np.asarray(inputs.cosmology.hubble(np.asarray(redshifts)))  # 1/s


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x
    return to_device(np.asarray(x, np.float32), resolve_device(device))


def _gradient_last_axis(arr, dx, periodic: bool):
    """np.gradient(edge_order=2) along the last axis, or the spectral
    derivative when periodic."""
    if periodic:
        n = arr.shape[-1]
        k = torch.fft.rfftfreq(n, dx, device=arr.device) * (2 * np.pi)
        return torch.fft.irfft(1j * k * torch.fft.rfft(arr, dim=-1), n=n, dim=-1)
    interior = (arr[..., 2:] - arr[..., :-2]) / (2 * dx)
    lo = (-3 * arr[..., :1] + 4 * arr[..., 1:2] - arr[..., 2:3]) / (2 * dx)
    hi = (3 * arr[..., -1:] - 4 * arr[..., -2:-1] + arr[..., -3:-2]) / (2 * dx)
    return torch.cat([lo, interior, hi], dim=-1)


def include_dvdr_in_tau21(
    brightness_temp,
    los_velocity,
    redshifts,
    inputs: InputParameters,
    periodic: bool,
    tau_21=None,
    *,
    device="cuda",
):
    """Velocity-gradient correction to the 21-cm optical depth / Tb along the
    last axis, whose slices lie at `redshifts`.

    Without Ts: Tb -> Tb / |1 + dv/dr / H| (clipped at MAX_DVDR).
    With Ts: full (1-exp(-tau/grad))/(1-exp(-tau)) factor (rsds.py:83-104)."""
    dx = float(inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM)
    if tau_21 is None and inputs.astro_options.USE_TS_FLUCT:
        raise ValueError("tau_21 required when USE_TS_FLUCT is True")
    bt = _as_tensor(brightness_temp, device)
    vel = _as_tensor(los_velocity, device)
    H = to_device(_hubble_of_z(inputs, redshifts).astype(np.float32), bt.device)

    vel_grad = _gradient_last_axis(vel, dx, periodic)
    if tau_21 is None:
        lim = H * float(inputs.astro_params.MAX_DVDR)
        dvdx = torch.clamp(vel_grad, -lim, lim)
        return bt / torch.abs(1.0 + dvdx / H)
    tau = _as_tensor(tau_21, device)
    grad_comp = torch.abs(1.0 + vel_grad / H)
    # expm1 keeps the small-tau ratio well-conditioned in float32
    factor = torch.expm1(-tau / grad_comp) / torch.expm1(-tau)
    factor = torch.where(tau < 1e-10, 1.0, factor)
    return bt * factor


def _fine_grid(n_slices: int, n_sub: int, periodic: bool, device):
    """What jnp.interp does, per fine cell, to interpolate the cell-centred
    coarse displacement onto the fine grid, in its own float32 arithmetic
    (host numpy, the grid is one sightline long): the lower knot `lo` (index
    into the padded knots when periodic), the offset `delta` from it, the
    masks of fine cells left of the first knot and right of the last (held
    at the end values), and the fine-cell centres in fine-pixel units; as
    tensors on `device`."""
    n_fine = n_slices * n_sub
    fine = (np.arange(n_fine, dtype=np.float32) + np.float32(0.5)) / np.float32(n_sub)
    knots = np.arange(n_slices, dtype=np.float32) + np.float32(0.5)
    if periodic:
        knots = np.concatenate([knots[:1] - np.float32(1), knots, knots[-1:] + np.float32(1)])
    i = np.clip(np.searchsorted(knots, fine, side="right"), 1, len(knots) - 1)
    grid = (i - 1, fine - knots[i - 1], fine < knots[0], fine > knots[-1], fine * np.float32(n_sub))
    return tuple(to_device(a, device) for a in grid)


def _shift_last_axis(field, disp, grid, n_sub: int, periodic: bool):
    """rsds_shift along the last axis of (n_coords, n_slices) tensors."""
    lo, delta, left, right, fine_pos = grid
    n_coords, n_slices = field.shape
    n_fine = n_slices * n_sub
    if periodic:
        disp = torch.cat([disp[:, -1:], disp, disp[:, :1]], dim=1)
    f_lo, f_hi = disp[:, lo], disp[:, lo + 1]
    disp_fine = f_lo + delta * (f_hi - f_lo)
    disp_fine = torch.where(left, disp[:, :1], disp_fine)
    disp_fine = torch.where(right, disp[:, -1:], disp_fine)

    new_pos = (fine_pos + disp_fine * n_sub) - 0.5  # CIC about fine-cell centres
    i0f = torch.floor(new_pos)
    frac = new_pos - i0f
    del new_pos, disp_fine
    i0 = i0f.long()
    i1 = i0 + 1
    if periodic:
        i0, i1 = torch.remainder(i0, n_fine), torch.remainder(i1, n_fine)
    else:
        i0, i1 = torch.clamp(i0, 0, n_fine - 1), torch.clamp(i1, 0, n_fine - 1)
    fine_field = torch.repeat_interleave(field, n_sub, dim=1) / n_sub
    out = torch.zeros((n_coords, n_fine), dtype=torch.float32, device=field.device)
    out.scatter_add_(1, i0, fine_field * (1 - frac))
    out.scatter_add_(1, i1, fine_field * frac)
    # re-bin fine cells to coarse slices
    return out.reshape(n_coords, n_slices, n_sub).sum(dim=2)


def rsds_shift(field, los_displacement_pix, n_rsd_subcells: int = 4, periodic: bool = False,
               *, device="cuda"):
    """Shift cells along the LoS by a (pixel-unit) displacement with sub-cell CIC.

    field, los_displacement_pix: shape (n_slices, n_coords).  Each cell is split
    into `n_rsd_subcells`, moved by the (linearly interpolated) displacement,
    and CIC-deposited back (reference rsds_shift:184-266).
    """
    field = _as_tensor(field, device).float()
    disp = _as_tensor(los_displacement_pix, device).float()
    grid = _fine_grid(field.shape[0], n_rsd_subcells, periodic, field.device)
    return _shift_last_axis(field.T, disp.T, grid, n_rsd_subcells, periodic).T


def apply_rsds(
    field,
    los_velocity,
    redshifts,
    inputs: InputParameters,
    periodic: bool,
    n_rsd_subcells: int = 4,
    *,
    device="cuda",
):
    """Apply RSDs to a (rectilinear or flattened-angular) field along its
    last axis (reference apply_rsds:106-183).  Sightlines are shifted in
    chunks whose fine-grid temporaries stay under about 2 GiB."""
    field = _as_tensor(field, device)
    vel = _as_tensor(los_velocity, device)
    H = _hubble_of_z(inputs, redshifts)  # 1/s
    cell = inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM
    disp_pix = vel / to_device((H * cell).astype(np.float32), field.device)

    n_slices = field.shape[-1]
    field2d = field.reshape(-1, n_slices)
    disp2d = disp_pix.reshape(-1, n_slices)
    del disp_pix
    grid = _fine_grid(n_slices, n_rsd_subcells, periodic, field.device)
    chunk = max(1, _RSD_CHUNK_BYTES // (_RSD_BYTES_PER_FINE_CELL * n_slices * n_rsd_subcells))
    out = torch.empty_like(field2d)
    for c0 in range(0, field2d.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        out[sl] = _shift_last_axis(field2d[sl], disp2d[sl], grid, n_rsd_subcells, periodic)
    return out.reshape(field.shape)
