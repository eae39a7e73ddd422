"""Carry state across from the JAX package (py21cmfast_tpu) as plain data.

The port never imports the JAX package.  A caller that holds both (the
parity tests do) hands the JAX package's inputs over as the `attrs.asdict`
dict of each parameter group plus `random_seed`/`node_redshifts`, and its
output structs as dicts of numpy arrays; these functions rebuild the port's
own objects from them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .drivers.coeval import Coeval
from .inputs import (
    AstroOptions,
    AstroParams,
    CosmoParams,
    InputParameters,
    MatterOptions,
    SimulationOptions,
)
from .outputs import (
    BrightnessTemp,
    HaloBox,
    InitialConditions,
    IonizedBox,
    PerturbedField,
    TsBox,
    XraySourceBox,
)

__all__ = [
    "inputs_from_dict",
    "initial_conditions_from_numpy",
    "perturbed_field_from_numpy",
    "ionized_box_from_numpy",
    "brightness_temp_from_numpy",
    "ts_box_from_numpy",
    "halobox_from_numpy",
    "xray_source_box_from_numpy",
    "coeval_from_numpy",
]

_GROUPS = {
    "cosmo_params": CosmoParams,
    "matter_options": MatterOptions,
    "simulation_options": SimulationOptions,
    "astro_options": AstroOptions,
    "astro_params": AstroParams,
}


def inputs_from_dict(d: dict) -> InputParameters:
    """InputParameters from `{group: attrs.asdict(group), "random_seed": ..,
    "node_redshifts": ..}` — the JAX package's groups carry the same fields,
    so both packages then hash the inputs alike (`full_hash`)."""
    return InputParameters(
        random_seed=d["random_seed"],
        node_redshifts=tuple(d.get("node_redshifts", ())),
        **{name: cls(**d[name]) for name, cls in _GROUPS.items()},
    )


def _struct_from_numpy(cls, arrays: dict, device):
    """Grids (ndim > 0) become float32 tensors on `device`; scalars become
    numpy float32; fields missing from `arrays` or None stay None."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        v = arrays.get(f.name)
        if v is None:
            kw[f.name] = None
        elif np.ndim(v) > 0:
            kw[f.name] = torch.as_tensor(np.asarray(v, np.float32), device=dev)
        else:
            kw[f.name] = np.float32(v)
    return cls(**kw)


def initial_conditions_from_numpy(arrays: dict, device="cuda") -> InitialConditions:
    return _struct_from_numpy(InitialConditions, arrays, device)


def perturbed_field_from_numpy(arrays: dict, device="cuda") -> PerturbedField:
    return _struct_from_numpy(PerturbedField, arrays, device)


def ionized_box_from_numpy(arrays: dict, device="cuda") -> IonizedBox:
    return _struct_from_numpy(IonizedBox, arrays, device)


def brightness_temp_from_numpy(arrays: dict, device="cuda") -> BrightnessTemp:
    return _struct_from_numpy(BrightnessTemp, arrays, device)


def ts_box_from_numpy(arrays: dict, device="cuda") -> TsBox:
    return _struct_from_numpy(TsBox, arrays, device)


def halobox_from_numpy(arrays: dict, device="cuda") -> HaloBox:
    return _struct_from_numpy(HaloBox, arrays, device)


def xray_source_box_from_numpy(arrays: dict, device="cuda") -> XraySourceBox:
    return _struct_from_numpy(XraySourceBox, arrays, device)


def coeval_from_numpy(arrays: dict, device="cuda") -> Coeval:
    """A Coeval from `{"redshift": z, "initial_conditions": {..},
    "perturbed_field": {..}, "ionized_box": {..}, "brightness_temperature":
    {..}, "spin_temp": {..} or None, "halobox": {..} or None}`, each struct a
    dict of numpy arrays."""
    ts = arrays.get("spin_temp")
    hb = arrays.get("halobox")
    return Coeval(
        redshift=float(arrays["redshift"]),
        initial_conditions=initial_conditions_from_numpy(arrays["initial_conditions"], device),
        perturbed_field=perturbed_field_from_numpy(arrays["perturbed_field"], device),
        ionized_box=ionized_box_from_numpy(arrays["ionized_box"], device),
        brightness_temperature=brightness_temp_from_numpy(arrays["brightness_temperature"], device),
        spin_temp=None if ts is None else ts_box_from_numpy(ts, device),
        halobox=None if hb is None else halobox_from_numpy(hb, device),
    )
