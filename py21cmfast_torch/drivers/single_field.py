"""Single-field helpers of the user-facing API (reference
drivers/single_field.py), following py21cmfast_tpu/drivers/single_field.py.

Only `interp_halo_boxes` lives here; the compute functions are exported by
the package from their model modules.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..outputs import HaloBox

__all__ = ["interp_halo_boxes"]


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
