"""3D real FFT wrappers (cuFFT on the card through `torch.fft`).

Conventions: forward = unnormalized sum (numpy default, `norm="backward"`),
inverse includes 1/N — i.e. `irfft3(rfft3(x)) == x`.  See models/ics.py for how
this maps onto the reference's FFTW normalization bookkeeping.
"""

from __future__ import annotations

import torch


def rfft3(x):
    return torch.fft.rfftn(x, dim=(0, 1, 2))


def irfft3(kx, shape=None):
    if shape is None:
        n0, n1, nzh = kx.shape
        shape = (n0, n1, 2 * (nzh - 1))
    return torch.fft.irfftn(kx, s=tuple(shape), dim=(0, 1, 2))
