"""Power-spectrum estimation of 3D boxes (replaces `powerbox` in tests and
benchmarks), following py21cmfast_tpu/ops/ps.py.

Conventions: for a real field f on an (Nx,Ny,Nz) grid of comoving volume V,
  d_k = rfftn(f)  (unnormalized forward)
  P(k) = <|d_k|^2> * V / N^2
which matches the reference's sampling convention E|d_k|^2 = N^2 P / V used in
the GRF (see models/ics.py) and the powerbox estimator used by the golden tests
(test_integration_features.py).

`power_spectrum_1d` takes the FFT on the field's device (float32, as the JAX
package's); |k| is the float32 grid of ops/grids.py, correctly rounded as the
JAX package's, and the binning runs on the host in float64 as there.
`reference_binned_power` is host numpy, a copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from . import grids


def _half_space_weights(nz):
    """Hermitian multiplicity of the rfft half-space: the kz=0 plane (and the
    kz=Nyquist plane for even Nz) count once, the others twice."""
    w = np.full(nz // 2 + 1, 2.0)
    w[0] = 1.0
    if nz % 2 == 0:
        w[-1] = 1.0
    return w


def power_spectrum_1d(field, box_lens, n_bins=16, k_min=None, k_max=None, log_bins=True,
                      *, device="cuda"):
    """Spherically-averaged P(k) of a real 3D field.

    `field` is a tensor (the FFT runs on its device) or an array, which is
    moved to `device` first.  Returns (k_centers, P(k), counts) as numpy
    arrays (host)."""
    if not isinstance(field, torch.Tensor):
        field = torch.as_tensor(np.asarray(field, np.float32), device=resolve_device(device))
    field = field.float()
    shape = tuple(field.shape)
    n_tot = int(np.prod(shape))
    volume = float(np.prod(box_lens))

    d_k = torch.fft.rfftn(field)
    pk_grid = d_k.abs() ** 2 * (volume / n_tot**2)
    del d_k
    kmag = grids.kmag_grid(shape, box_lens, field.device)

    kmag = kmag.cpu().numpy().astype(np.float64).ravel()
    pk = pk_grid.cpu().numpy().astype(np.float64).ravel()
    weights = np.broadcast_to(_half_space_weights(shape[2])[None, None, :],
                              tuple(pk_grid.shape)).ravel()

    if k_min is None:
        k_min = 2 * np.pi / max(box_lens)
    if k_max is None:
        k_max = np.pi * min(s / l for s, l in zip(shape, box_lens))  # Nyquist

    if log_bins:
        edges = np.logspace(np.log10(k_min), np.log10(k_max), n_bins + 1)
    else:
        edges = np.linspace(k_min, k_max, n_bins + 1)

    idx = np.digitize(kmag, edges) - 1
    valid = (idx >= 0) & (idx < n_bins) & (kmag > 0)
    psum = np.bincount(idx[valid], weights=(pk * weights)[valid], minlength=n_bins)
    ksum = np.bincount(idx[valid], weights=(kmag * weights)[valid], minlength=n_bins)
    counts = np.bincount(idx[valid], weights=weights[valid], minlength=n_bins)
    with np.errstate(invalid="ignore"):
        return ksum / counts, psum / counts, counts


def reference_binned_power(field, box_lens, bins=None):
    """P(k) binned exactly like the reference golden tests.

    The reference produces its gold spectra with powerbox.get_power(field,
    boxlength=BOX_LEN, bins_upto_boxlen=True) (produce_integration_test_data.py:
    84-280).  That scheme, reverse-engineered against the stored gold k-centers
    (matches to <5e-9):

      bins    = int(N_geom // 2.2), N_geom = prod(shape)**(1/3)
      edges   = linspace(0, min-axis Nyquist, bins+1)   [linear; DC in bin 0;
                 modes with |k| == Nyquist dropped]
      k_c     = unweighted mean |k| of the full-FFT modes in the bin
      P       = mean |fftn(f)|^2 * V / N_tot^2 over the bin

    Implemented on the rfft half-space with hermitian multiplicity weights
    (equivalent to full-fftn mode counting), in float64 on the host (a
    tensor is copied there).  Returns (k_centers, P, counts).
    """
    if isinstance(field, torch.Tensor):
        field = field.detach().cpu().numpy()
    field = np.asarray(field, dtype=np.float64)
    shape = field.shape
    n_tot = int(np.prod(shape))
    if np.isscalar(box_lens):
        box_lens = (float(box_lens),) * 3
    volume = float(np.prod(box_lens))

    if bins is None:
        bins = int(n_tot ** (1.0 / 3.0) // 2.2)

    d_k = np.fft.rfftn(field)
    pk_grid = (np.abs(d_k) ** 2) * (volume / n_tot**2)

    axes = [2 * np.pi * np.fft.fftfreq(s, d=l / s) for s, l in zip(shape, box_lens)]
    axes[2] = axes[2][: shape[2] // 2 + 1]
    kmag = np.sqrt(
        axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2 + axes[2][None, None, :] ** 2
    )
    weights = np.broadcast_to(_half_space_weights(shape[2])[None, None, :], pk_grid.shape)

    kny = min(np.pi * s / l for s, l in zip(shape, box_lens))
    edges = np.linspace(0.0, kny, bins + 1)

    mag = kmag.ravel()
    pk = pk_grid.ravel()
    wts = weights.ravel()
    idx = np.digitize(mag, edges) - 1
    valid = (idx >= 0) & (idx < bins)
    psum = np.bincount(idx[valid], weights=(pk * wts)[valid], minlength=bins)
    ksum = np.bincount(idx[valid], weights=(mag * wts)[valid], minlength=bins)
    counts = np.bincount(idx[valid], weights=wts[valid], minlength=bins)
    with np.errstate(invalid="ignore"):
        return ksum / counts, psum / counts, counts


def dimensionless_power(field, box_lens, *, device="cuda", **kw):
    """Delta^2(k) = k^3 P(k) / (2 pi^2)."""
    k, p, n = power_spectrum_1d(field, box_lens, device=device, **kw)
    return k, k**3 * p / (2 * np.pi**2), n
