"""The reference's lightcone: the node ladder from the highest redshift down,
each node's perturbed field (`plain.perturb`), spin temperature and
ionization (the frozen astrophysics of `models/`), brightness temperature
(`plain.brightness`), the slices between each pair of nodes, then the
velocity-gradient correction and the RSDs (`plain`).  Where the
configuration samples halos, each node first moves its catalog and grids it
into a HaloBox, and the spin temperature reads the XraySourceBox of the
HaloBoxes so far (`halos`), in the program's order of a node.

`rounding` puts the reference one precision lower: it is applied to every
stage's output before the next stage reads it (see harness/reference.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import halos, plain
from .models import ionization, spintemp
from .outputs import PerturbedField

F32 = torch.float32


def _slim(ion):
    """What the next node reads of an ionized box."""
    return dataclasses.replace(ion, neutral_fraction=None, mean_free_path=None,
                               kinetic_temperature=None)


def cone(inputs, ics: plain.ICs, quantities, include_dvdr, apply_rsds, dev,
         rounding=lambda x: x, band=None, catalogs=None) -> dict:
    """{quantity: float64 (N, N, n_slices) tensor} of the finished cone from
    `ics`; `quantities` as the program's cone holds them.  Every node of the
    ladder is computed; the slices span `band` (z_min, z_max), the whole
    ladder by default.  Where the configuration samples halos, `catalogs`
    maps each node's float32 redshift to its halo catalog."""
    use_ts = inputs.astro_options.USE_TS_FLUCT
    sampler = inputs.matter_options.source_model_uses_halo_sampler
    if sampler and catalogs is None:
        raise ValueError("the configuration samples halos: the cone needs its catalogs")
    z_nodes = [float(z) for z in inputs.node_redshifts]  # descending
    cosmo = inputs.cosmology
    dists = plain.slice_distances(inputs, *(band or (min(z_nodes), max(z_nodes))))
    n_lo = inputs.simulation_options.HII_DIM
    cones = {q: torch.zeros((n_lo, n_lo, len(dists)), dtype=torch.float64, device=dev)
             for q in quantities}

    prev = prev_ion = ts_state = prev_z = None
    history = []  # (z, the SFR and X-ray grids of the node's HaloBox)
    for z in z_nodes:
        density, v_z = rounding(plain.perturb(z, inputs, ics))
        pf = PerturbedField(redshift=np.float32(z), density=density.to(F32),
                            velocity_z=v_z.to(F32))
        hb = None
        if sampler:
            catalog = catalogs.get(float(np.float32(z)))
            if catalog is None:
                raise ValueError(f"no halo catalog for the node at z={z}")
            hb = rounding(halos.halo_box(z, inputs, ics, catalog,
                                         halos.perturb_catalog(z, inputs, ics, catalog)))
        ts = None
        if use_ts:
            source = None
            if hb is not None:
                history.append((z, dataclasses.replace(hb, n_ion=None, whalo_sfr=None)))
                if ts_state is not None and z < inputs.simulation_options.Z_HEAT_MAX:
                    source = rounding(halos.xray_source_box(z, inputs, history))
            ts, ts_state = rounding(spintemp.compute_spin_temperature(
                z, inputs, pf, prev_state=ts_state, prev_redshift=prev_z,
                source_box=source, previous_ionized_box=prev_ion, device=dev))
            del source
            if z != z_nodes[-1]:  # the next node's host tables, on a worker thread
                spintemp.prefetch_sfrd_tables(z_nodes[z_nodes.index(z) + 1], inputs)
        ion = rounding(ionization.compute_ionization_field(
            z, inputs, pf, previous_ionized_box=prev_ion, spin_temp=ts, prev_redshift=prev_z,
            halobox=hb, device=dev))
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
        del pf, ion, ts, hb, fields

    z_slices = plain.slice_redshifts(inputs, dists)
    if include_dvdr:
        cones["brightness_temp"] = plain.include_dvdr(
            inputs, cones["brightness_temp"], cones["velocity_z"], z_slices,
            cones["tau_21"] if use_ts else None)
    if apply_rsds:
        cones["brightness_temp"] = plain.rsds(
            inputs, cones["brightness_temp"], cones["velocity_z"], z_slices)
    return cones
