"""k-space filter bank.

Behavioral parity with reference filtering.c:18-307.  Every filter is a pure
function of the |k| grid.  Filter ids match the reference; this slice carries
the three that the saturated-Ts coeval uses:

  0: real-space spherical tophat        W(kR) = 3 (sin kR - kR cos kR)/(kR)^3
  1: sharp-k                            W = [kR * 0.4136 <= 1]
  2: gaussian (width 0.643/R)           W = exp(-0.643^2 (kR)^2/2)

The exponential-MFP (3), shell (4) and multiple-scattering (5) windows come
with the Lagrangian-source slice.
"""

from __future__ import annotations

import torch

from .._device import not_in_slice

TOPHAT = 0
SHARPK = 1
GAUSSIAN = 2
EXP_MFP = 3
SHELL = 4


def w_tophat(kr):
    safe = torch.where(kr < 1e-4, 1.0, kr)
    w = 3.0 * (torch.sin(safe) - safe * torch.cos(safe)) / safe**3
    return torch.where(kr < 1e-4, 1.0 - kr * kr / 10.0, w)


def w_sharpk(kr):
    return torch.where(kr * 0.413566994 > 1.0, 0.0, 1.0)


def w_gaussian_sq(kr_sq):
    return torch.exp(-0.643 * 0.643 * kr_sq / 2.0)


def filter_weights(kmag, filter_type: int, R):
    """Return W(k) for the given filter id on the |k| grid."""
    if filter_type == TOPHAT:
        return w_tophat(kmag * R)
    if filter_type == SHARPK:
        return w_sharpk(kmag * R)
    if filter_type == GAUSSIAN:
        return w_gaussian_sq((kmag * R) ** 2)
    if filter_type in (EXP_MFP, SHELL):
        not_in_slice(f"filter type {filter_type} (exp-MFP / shell)", 12)
    raise ValueError(f"unknown filter type {filter_type}")


def filter_kbox(kbox, kmag, filter_type: int, R):
    """Multiply a k-space half-space box by the filter window."""
    return kbox * filter_weights(kmag, filter_type, R).to(kbox.real.dtype)
