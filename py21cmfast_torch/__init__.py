"""py21cmfast_torch — the PyTorch/CUDA port of py21cmfast_tpu for NVIDIA Hopper.

It runs the coeval (ICs -> 2LPT perturb with the swept CIC deposit ->
excursion-set ionization -> brightness temperature), one redshift at a time
with a saturated spin temperature or evolved down the node redshifts with
the spin temperature and recombinations, with the JAX package's names and
inputs.  Device fields are float32 tensors, host tables float64.  Every entry point takes `device="cuda"` and runs on the card;
the CPU is used only when the caller passes `device="cpu"`.  Options that are
not ported yet raise NotImplementedError naming the ROADMAP item that brings
them.  The swept CIC deposit is a hand-written CUDA kernel
(`csrc/cic_deposit.cu`), built with nvcc at its first use.
"""

__version__ = "0.1.0"

from pathlib import Path as _Path

_DATA_PATH = _Path(__file__).parent / "_data"

from . import interop
from ._cfg import config
from ._templates import create_params_from_template, list_templates, write_template
from .drivers.coeval import Coeval, generate_coeval, run_coeval
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
from .models.brightness import brightness_temperature
from .models.ics import compute_initial_conditions
from .models.ionization import compute_ionization_field
from .models.perturb import perturb_field
from .models.spintemp import compute_spin_temperature
from .outputs import BrightnessTemp, InitialConditions, IonizedBox, PerturbedField, TsBox

__all__ = [
    "_DATA_PATH",
    "AstroOptions",
    "AstroParams",
    "BrightnessTemp",
    "Coeval",
    "CosmoParams",
    "InfinityOrNaNError",
    "InitialConditions",
    "InputParameters",
    "IonizedBox",
    "MatterOptions",
    "ParameterError",
    "PerturbedField",
    "SimulationOptions",
    "TsBox",
    "__version__",
    "brightness_temperature",
    "compute_initial_conditions",
    "compute_ionization_field",
    "compute_spin_temperature",
    "config",
    "create_params_from_template",
    "generate_coeval",
    "get_logspaced_redshifts",
    "interop",
    "list_templates",
    "perturb_field",
    "register_class_transfer",
    "run_coeval",
    "write_template",
]
