"""Cosmology: transfer functions, power spectrum, growth, sigma(M) tables."""

from .constants import physconst
from .power import FILTER_GAUSSIAN, FILTER_SHARPK, FILTER_TOPHAT, Cosmology, SigmaTable

__all__ = [
    "physconst",
    "Cosmology",
    "SigmaTable",
    "FILTER_TOPHAT",
    "FILTER_SHARPK",
    "FILTER_GAUSSIAN",
]
