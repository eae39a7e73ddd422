"""float32 erfc and erfinv as XLA evaluates them.

The JAX package's progenitor samplers call `jax.scipy.special.erfc` and
`erfinv` in float32, which XLA lowers to fixed polynomial approximations
(Cephes' erf/erfc rational fits and Giles' erfinv): their results sit up to
2e-6 (erfc) and 6e-6 (erfinv) of their value off the exact functions, where
torch's own are within an ulp.  The partition sampler's inverse-CDF draw
amplifies that into its masses and its acceptance tests, so the port
evaluates the same approximations, op by op in float32, on every device.
The constants enter as Python floats, which torch rounds to float32 as XLA
does, so that no step copies a scalar to the card.

The float32 log, log1p, exp and pow of the card and of the CPU differ by an
ulp here and there, and the samplers' accept/stop tests and their
(0.5^eta - q^eta)/eta cancel such ulps into other decisions.  `log32`,
`log1p32`, `exp32` and `pow32` take them in float64 and round once, which
gives the same float32 on both devices.
"""

from __future__ import annotations

import torch

# Giles' single-precision erfinv: coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# Cephes: erf on |x| < 1, erfc on 1 <= |x| < 2 and on |x| >= 2 (in 1/x^2)
_ERF_T = (7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129, 0.112835854,
          -0.37612626, 1.12837911)
_ERFC_P = (0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469, -0.494451523,
           0.340488, -0.274112701, 0.563825965)
_ERFC_R = (-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523, 0.42184633,
           -0.282076746, 0.564189494)
_MAXLOG = -88.7228394


def log32(x):
    return torch.log(x.double()).float()


def log1p32(x):
    return torch.log1p(x.double()).float()


def exp32(x):
    return torch.exp(x.double()).float()


def pow32(x, y):
    """x^y rounded once from float64; either may be a Python float."""
    x = x.double() if isinstance(x, torch.Tensor) else x
    y = y.double() if isinstance(y, torch.Tensor) else y
    return torch.pow(x, y).float()


def _horner(coeffs, w):
    """c0 w^(n-1) + ... + c_(n-1), one float32 multiply and add a term."""
    p = w * coeffs[0] + coeffs[1]
    for c in coeffs[2:]:
        p = p * w + c
    return p


def erfinv32(x):
    """XLA's float32 erf_inv (Giles 2010)."""
    w = -log1p32(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def erfc32(x):
    """XLA's float32 erfc (Cephes): 1 - erf(x) on |x| < 1, else
    exp(-x^2)/|x| times a fit in 1/x^2, 0 where exp(-x^2) underflows."""
    ax = x.abs()
    xsq = x * x
    small = 1.0 - x * _horner(_ERF_T, xsq)
    nxsq = -xsq
    inv_sq = torch.reciprocal(xsq)
    tail = exp32(nxsq) * torch.reciprocal(ax)
    tail = tail * torch.where(ax < 2.0, _horner(_ERFC_P, inv_sq), _horner(_ERFC_R, inv_sq))
    tail = torch.where(nxsq < _MAXLOG, 0.0, tail)
    tail = torch.where(x < 0.0, 2.0 - tail, tail)
    return torch.where(ax < 1.0, small, tail)
