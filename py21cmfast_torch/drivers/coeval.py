"""Coeval cubes: the snapshot pipeline, evolved down the node ladder.

Equivalent of reference drivers/coeval.py:521-992 (`generate_coeval` /
`run_coeval`), following py21cmfast_tpu/drivers/coeval.py without the cache
and the halo chain: the ICs are computed once, then the union of the node
redshifts and the requested ones is visited highest first.  Each node runs
perturb -> Ts -> prefetch of the next node's tables -> ionize -> Tb; the
ionized box and the spin-temperature state are handed to the next node, and
only the requested redshifts are yielded.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .._device import not_in_slice, resolve_device
from ..exceptions import check_nonfinite
from ..inputs import InputParameters
from ..models import ics as ics_module
from ..models import ionization, perturb, spintemp
from ..models.brightness import brightness_temperature
from ..outputs import BrightnessTemp, InitialConditions, IonizedBox, PerturbedField, TsBox

__all__ = ["Coeval", "run_coeval", "generate_coeval"]


@dataclasses.dataclass
class Coeval:
    """All output boxes at one redshift (reference coeval.py:61)."""

    redshift: float
    initial_conditions: InitialConditions
    perturbed_field: PerturbedField
    ionized_box: IonizedBox
    brightness_temperature: BrightnessTemp
    spin_temp: TsBox | None = None

    @property
    def brightness_temp(self):
        return self.brightness_temperature.brightness_temp

    @property
    def neutral_fraction(self):
        return self.ionized_box.neutral_fraction

    @property
    def density(self):
        return self.perturbed_field.density


def _slim_chain_ion(ion: IonizedBox | None):
    """Drop the IonizedBox fields nothing downstream in the scroll reads: the
    next snapshot only needs z_reion, ionisation_rate_G12, the mean f_coll
    scalars, cumulative_recombinations and the unnormalised_nion stacks."""
    if ion is None:
        return ion
    return dataclasses.replace(
        ion, neutral_fraction=None, mean_free_path=None, kinetic_temperature=None
    )


def _slim_chain_pf(pf: PerturbedField | None, needed: bool):
    """The previous PerturbedField is read only by the minihalo Nion
    trapezoid (ionization's tracked Nion history), and then only its density."""
    if pf is None or not needed:
        return None
    return dataclasses.replace(pf, velocity_z=None, velocity_x=None, velocity_y=None)


def _required_redshifts(inputs: InputParameters, out_redshifts):
    """Union of node redshifts and requested outputs, descending
    (reference _get_required_redshifts_coeval, coeval.py:971)."""
    zs = set(float(z) for z in out_redshifts)
    zs |= set(float(z) for z in inputs.node_redshifts)
    return sorted(zs, reverse=True)


def generate_coeval(
    inputs: InputParameters,
    out_redshifts=(),
    initial_conditions: InitialConditions | None = None,
    cache=None,
    *,
    device="cuda",
):
    """Yield a Coeval at each requested redshift, highest first, evolving
    down the node-redshift ladder (reference _redshift_loop_generator,
    coeval.py:749).  Every snapshot's fields are checked for NaN/Inf."""
    dev = resolve_device(device)
    if cache is not None:
        not_in_slice("the output cache", 16)
    ao = inputs.astro_options
    perturb.check_inputs(inputs)
    ionization.check_inputs(inputs)
    if ao.USE_TS_FLUCT:
        spintemp.check_inputs(inputs)
    out_redshifts = [float(z) for z in np.atleast_1d(np.asarray(out_redshifts))]
    all_z = _required_redshifts(inputs, out_redshifts)
    if not all_z:
        raise ValueError("no redshifts requested")

    needs_evolution = ao.USE_TS_FLUCT or ao.uses_recombination or inputs.node_redshifts

    if initial_conditions is None:
        initial_conditions = ics_module.compute_initial_conditions(inputs, device=dev)

    prev_ion: IonizedBox | None = None
    prev_pf: PerturbedField | None = None
    prev_z = None
    ts_state = None
    for i, z in enumerate(all_z):
        pf = perturb.perturb_field(z, inputs, initial_conditions, device=dev)

        ts = None
        if ao.USE_TS_FLUCT:
            ts, ts_state = spintemp.compute_spin_temperature(
                z, inputs, pf, prev_state=ts_state, prev_redshift=prev_z,
                initial_conditions=initial_conditions, previous_ionized_box=prev_ion,
                device=dev,
            )
            # overlap the next node's host-side SFRD tables with this node's
            # device work (worker thread; see spintemp.prefetch_sfrd_tables)
            if i + 1 < len(all_z):
                spintemp.prefetch_sfrd_tables(all_z[i + 1], inputs)

        ion = ionization.compute_ionization_field(
            z, inputs, pf, previous_ionized_box=prev_ion, spin_temp=ts,
            prev_redshift=prev_z, previous_perturbed_field=prev_pf,
            vcb_box=initial_conditions.lowres_vcb, device=dev,
        )
        # the previous node's Nion stacks (2 x n_R grids with minihalos) are
        # read: release the scroll's hold on them now
        prev_ion = prev_pf = None
        tb = brightness_temperature(inputs, ion, pf, spin_temp=ts, device=dev)
        check_nonfinite(z, pf, ts, ion, tb)

        if (not out_redshifts) or any(abs(z - oz) < 1e-8 for oz in out_redshifts):
            yield Coeval(
                redshift=z,
                initial_conditions=initial_conditions,
                perturbed_field=pf,
                ionized_box=ion,
                brightness_temperature=tb,
                spin_temp=ts,
            )

        # keep only what the next snapshot reads; without evolution there is
        # no coupling between snapshots
        prev_ion = _slim_chain_ion(ion) if needs_evolution else None
        prev_pf = _slim_chain_pf(pf, needed=ao.USE_MINI_HALOS)
        prev_z = z
        del ion, pf, ts, tb


def run_coeval(
    inputs: InputParameters,
    out_redshifts,
    initial_conditions: InitialConditions | None = None,
    cache=None,
    *,
    device="cuda",
):
    """Compute coeval boxes at the given redshifts (reference run_coeval:690)."""
    single = np.isscalar(out_redshifts)
    coevals = list(
        generate_coeval(
            inputs, np.atleast_1d(out_redshifts), initial_conditions, cache, device=device
        )
    )
    return coevals[0] if single and len(coevals) == 1 else coevals
