"""Single-field compute functions: the user-facing per-field API
(reference drivers/single_field.py), following
py21cmfast_tpu/drivers/single_field.py: the compute functions of the model
modules, re-exported, and `interp_halo_boxes`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.brightness import brightness_temperature
from ..models.halobox import compute_fixed_halo_grid, compute_halo_grid
from ..models.halos import determine_halo_catalog, perturb_halo_catalog
from ..models.ics import compute_initial_conditions
from ..models.ionization import compute_ionization_field
from ..models.perturb import perturb_field
from ..models.spintemp import compute_spin_temperature
from ..models.xray_source import compute_xray_source_field
from ..outputs import HaloBox

__all__ = [
    "compute_initial_conditions",
    "perturb_field",
    "determine_halo_catalog",
    "perturb_halo_catalog",
    "compute_halo_grid",
    "compute_fixed_halo_grid",
    "interp_halo_boxes",
    "compute_xray_source_field",
    "compute_spin_temperature",
    "compute_ionization_field",
    "brightness_temperature",
]


def interp_halo_boxes(halo_boxes, fields, redshift: float) -> HaloBox:
    """Linearly interpolate a HaloBox history to `redshift`
    (reference interp_halo_boxes, single_field.py:382-467).

    `halo_boxes` must be in ascending redshift order; `fields` are the
    attribute names to interpolate (the others are taken from the
    descendant box, the one at or below `redshift`)."""
    z_halos = [float(b.redshift) for b in halo_boxes]
    if not np.all(np.diff(z_halos) > 0):
        raise ValueError("halo_boxes must be in ascending order of redshift")
    if redshift > z_halos[-1] or redshift < z_halos[0]:
        raise ValueError(
            f"invalid target z {redshift} for halo box range [{z_halos[0]}, {z_halos[-1]}]")

    idx_prog = max(int(np.searchsorted(z_halos, redshift, side="left")), 1)
    idx_desc = idx_prog - 1
    z_prog, z_desc = z_halos[idx_prog], z_halos[idx_desc]
    w = (redshift - z_desc) / (z_prog - z_desc)

    desc, prog = halo_boxes[idx_desc], halo_boxes[idx_prog]
    updates = {"redshift": np.float32(redshift)}
    for field in fields:
        f_desc, f_prog = getattr(desc, field), getattr(prog, field)
        if f_desc is not None and f_prog is not None:
            updates[field] = (1.0 - w) * f_desc + w * f_prog
    return dataclasses.replace(desc, **updates)
