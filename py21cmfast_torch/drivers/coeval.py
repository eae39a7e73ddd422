"""Coeval-cube driver: the snapshot pipeline without evolution.

Equivalent of reference drivers/coeval.py:521-992 (`generate_coeval` /
`run_coeval`), following py21cmfast_tpu/drivers/coeval.py for the path with
no node redshifts and no cache: the ICs are computed once, then each requested
redshift runs perturb -> ionize -> Tb on its own, highest redshift first.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .._device import not_in_slice, resolve_device
from ..exceptions import check_nonfinite
from ..inputs import InputParameters
from ..models import ics as ics_module
from ..models import ionization, perturb
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


def generate_coeval(
    inputs: InputParameters,
    out_redshifts=(),
    initial_conditions: InitialConditions | None = None,
    cache=None,
    *,
    device="cuda",
):
    """Yield a Coeval at each requested redshift, highest first.  Every
    snapshot's fields are checked for NaN/Inf before it is yielded."""
    dev = resolve_device(device)
    if cache is not None:
        not_in_slice("the output cache", 16)
    if inputs.node_redshifts:
        not_in_slice("a node-redshift scroll (node_redshifts)", 7)
    ics_module.check_inputs(inputs)
    perturb.check_inputs(inputs)
    ionization.check_inputs(inputs)
    all_z = sorted({float(z) for z in np.atleast_1d(np.asarray(out_redshifts))}, reverse=True)
    if not all_z:
        raise ValueError("no redshifts requested")

    if initial_conditions is None:
        initial_conditions = ics_module.compute_initial_conditions(inputs, device=dev)
    for z in all_z:
        pf = perturb.perturb_field(z, inputs, initial_conditions, device=dev)
        ion = ionization.compute_ionization_field(z, inputs, pf, device=dev)
        tb = brightness_temperature(inputs, ion, pf, device=dev)
        check_nonfinite(z, pf, ion, tb)
        yield Coeval(
            redshift=z,
            initial_conditions=initial_conditions,
            perturbed_field=pf,
            ionized_box=ion,
            brightness_temperature=tb,
        )


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
