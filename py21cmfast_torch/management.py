"""Memory / storage estimation (reference management.py:1-105 + cli predict),
a copy of py21cmfast_tpu/management.py."""

from __future__ import annotations

import numpy as np

from .inputs import InputParameters

_F32 = 4


def get_expected_outputs(inputs: InputParameters):
    """Which output classes a run with these inputs produces."""
    out = ["InitialConditions", "PerturbedField", "IonizedBox", "BrightnessTemp"]
    if inputs.astro_options.USE_TS_FLUCT:
        out += ["TsBox", "XraySourceBox"]
    if inputs.matter_options.source_model_uses_halo_sampler:
        out += ["HaloCatalog", "PerturbedHaloCatalog", "HaloBox"]
    elif inputs.matter_options.SOURCE_MODEL == "L-INTEGRAL":
        out += ["HaloBox"]
    return out


def get_expected_sizes(inputs: InputParameters) -> dict:
    """Approximate in-memory bytes per output class."""
    so = inputs.simulation_options
    hires = int(np.prod(so.hires_shape)) * _F32
    lowres = int(np.prod(so.lowres_shape)) * _F32
    n_ic = 8 if inputs.matter_options.PERTURB_ALGORITHM == "2LPT" else 5
    sizes = {
        "InitialConditions": hires + (n_ic - 1) * lowres,
        "PerturbedField": 2 * lowres,
        "IonizedBox": 4 * lowres,
        "BrightnessTemp": lowres,
    }
    if inputs.astro_options.USE_TS_FLUCT:
        sizes["TsBox"] = 3 * lowres
        sizes["XraySourceBox"] = 2 * inputs.astro_params.N_STEP_TS * lowres
    if "HaloBox" in get_expected_outputs(inputs):
        sizes["HaloBox"] = 5 * lowres
    return sizes


def get_total_storage_size(inputs: InputParameters, n_redshifts: int | None = None) -> int:
    """Total bytes to cache a full run."""
    n_z = n_redshifts if n_redshifts is not None else max(len(inputs.node_redshifts), 1)
    sizes = get_expected_sizes(inputs)
    total = sizes.pop("InitialConditions", 0)
    total += sum(sizes.values()) * n_z
    return total
