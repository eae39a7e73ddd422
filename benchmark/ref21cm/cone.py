"""The reference's lightcone: the node ladder from the highest redshift down,
each node's perturbed field (`plain.perturb`), spin temperature and
ionization (the frozen astrophysics of `models/`), brightness temperature
(`plain.brightness`), the slices between each pair of nodes, then the
velocity-gradient correction and the RSDs (`plain`).

`rounding` puts the reference one precision lower: it is applied to every
stage's output before the next stage reads it (see harness/reference.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import plain
from .models import ionization, spintemp
from .outputs import PerturbedField

F32 = torch.float32


def _slim(ion):
    """What the next node reads of an ionized box."""
    return dataclasses.replace(ion, neutral_fraction=None, mean_free_path=None,
                               kinetic_temperature=None)


def cone(inputs, ics: plain.ICs, quantities, include_dvdr, apply_rsds, dev,
         rounding=lambda x: x) -> dict:
    """{quantity: float64 (N, N, n_slices) tensor} of the finished cone from
    `ics`; `quantities` as the program's cone holds them."""
    use_ts = inputs.astro_options.USE_TS_FLUCT
    z_nodes = [float(z) for z in inputs.node_redshifts]  # descending
    cosmo = inputs.cosmology
    dists = plain.slice_distances(inputs, min(z_nodes), max(z_nodes))
    n_lo = inputs.simulation_options.HII_DIM
    cones = {q: torch.zeros((n_lo, n_lo, len(dists)), dtype=torch.float64, device=dev)
             for q in quantities}

    prev = prev_ion = ts_state = prev_z = None
    for z in z_nodes:
        density, v_z = rounding(plain.perturb(z, inputs, ics))
        pf = PerturbedField(redshift=np.float32(z), density=density.to(F32),
                            velocity_z=v_z.to(F32))
        ts = None
        if use_ts:
            ts, ts_state = rounding(spintemp.compute_spin_temperature(
                z, inputs, pf, prev_state=ts_state, prev_redshift=prev_z,
                previous_ionized_box=prev_ion, device=dev))
            if z != z_nodes[-1]:  # the next node's host tables, on a worker thread
                spintemp.prefetch_sfrd_tables(z_nodes[z_nodes.index(z) + 1], inputs)
        ion = rounding(ionization.compute_ionization_field(
            z, inputs, pf, previous_ionized_box=prev_ion, spin_temp=ts, prev_redshift=prev_z,
            device=dev))
        xh = ion.neutral_fraction.double()
        fields = {"density": density, "velocity_z": v_z, "neutral_fraction": xh}
        spin = None
        if ts is not None:
            spin = ts.spin_temperature.double()
            fields["spin_temperature"] = spin
            fields["xray_ionised_fraction"] = ts.xray_ionised_fraction.double()
        tb, tau = rounding(plain.brightness(inputs, z, xh, density, spin))
        fields["brightness_temp"], fields["tau_21"] = tb, tau
        if prev is not None:
            d_lo, d_hi = cosmo.comoving_distance(z), cosmo.comoving_distance(prev_z)
            for q in quantities:
                idx, vals = plain.slices(inputs, dists, d_lo, d_hi, fields[q], prev[q])
                if idx is not None:
                    cones[q][:, :, torch.as_tensor(idx, device=dev)] = vals
        prev = {q: fields[q] for q in quantities}
        prev_ion, prev_z = _slim(ion), z
        del pf, ion, ts, fields

    z_slices = plain.slice_redshifts(inputs, dists)
    if include_dvdr:
        cones["brightness_temp"] = plain.include_dvdr(
            inputs, cones["brightness_temp"], cones["velocity_z"], z_slices,
            cones["tau_21"] if use_ts else None)
    if apply_rsds:
        cones["brightness_temp"] = plain.rsds(
            inputs, cones["brightness_temp"], cones["velocity_z"], z_slices)
    return cones
