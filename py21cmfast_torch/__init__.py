"""py21cmfast_torch — the PyTorch/CUDA port of py21cmfast_tpu for NVIDIA Hopper.

It runs the coeval (ICs -> 2LPT perturb with the swept CIC deposit ->
excursion-set ionization -> brightness temperature), one redshift at a time
with a saturated spin temperature or evolved down the node redshifts with
the spin temperature and recombinations, and the lightcone assembled from
that scroll with the velocity-gradient correction and RSDs, for the
density-conditioned (E-INTEGRAL, CONST-ION-EFF) and fixed-grid (L-INTEGRAL,
through the HaloBox and the XraySourceBox) source models, with the JAX
package's names and inputs.  Device fields are float32 tensors, host tables float64.  Every entry point takes `device="cuda"` and runs on the card;
the CPU is used only when the caller passes `device="cpu"`.  Options that are
not ported yet raise NotImplementedError naming the ROADMAP item that brings
them.  The swept CIC deposit is a hand-written CUDA kernel
(`csrc/cic_deposit.cu`), built with nvcc at its first use.
"""

__version__ = "0.1.0"

from pathlib import Path as _Path

_DATA_PATH = _Path(__file__).parent / "_data"

from . import interop, lightconers
from ._cfg import config
from ._templates import create_params_from_template, list_templates, write_template
from .drivers.coeval import Coeval, generate_coeval, run_coeval
from .drivers.lightcone import LightCone, generate_lightcone, run_lightcone
from .exceptions import InfinityOrNaNError, ParameterError
from .inputs import (
    AstroOptions,
    AstroParams,
    CosmoParams,
    InputParameters,
    MatterOptions,
    SimulationOptions,
    get_logspaced_redshifts,
    register_class_transfer,
)
from .lightconers import AngularLightconer, Lightconer, RectilinearLightconer
from .models.brightness import brightness_temperature
from .models.ics import compute_initial_conditions
from .models.ionization import compute_ionization_field
from .models.perturb import perturb_field
from .models.spintemp import compute_spin_temperature
from .models.xray_source import compute_xray_source_field
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
    "_DATA_PATH",
    "AngularLightconer",
    "AstroOptions",
    "AstroParams",
    "BrightnessTemp",
    "Coeval",
    "CosmoParams",
    "HaloBox",
    "InfinityOrNaNError",
    "InitialConditions",
    "InputParameters",
    "IonizedBox",
    "LightCone",
    "Lightconer",
    "MatterOptions",
    "ParameterError",
    "PerturbedField",
    "RectilinearLightconer",
    "SimulationOptions",
    "TsBox",
    "XraySourceBox",
    "__version__",
    "brightness_temperature",
    "compute_initial_conditions",
    "compute_ionization_field",
    "compute_spin_temperature",
    "compute_xray_source_field",
    "config",
    "create_params_from_template",
    "generate_coeval",
    "generate_lightcone",
    "get_logspaced_redshifts",
    "interop",
    "lightconers",
    "list_templates",
    "perturb_field",
    "register_class_transfer",
    "run_coeval",
    "run_lightcone",
    "write_template",
]
