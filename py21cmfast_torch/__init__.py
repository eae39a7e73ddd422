"""py21cmfast_torch — the PyTorch/CUDA port of py21cmfast_tpu for NVIDIA Hopper.

It runs the coeval (ICs -> 2LPT perturb with the swept CIC deposit ->
excursion-set ionization -> brightness temperature), one redshift at a time
with a saturated spin temperature or evolved down the node redshifts with
the spin temperature and recombinations, and the lightcone assembled from
that scroll with the velocity-gradient correction and RSDs, for the
density-conditioned (E-INTEGRAL, CONST-ION-EFF) and fixed-grid (L-INTEGRAL,
through the HaloBox and the XraySourceBox) source models, with the JAX
package's names and inputs.  Device fields are float32 tensors, host tables float64.  Every entry point takes `device="cuda"` and runs on the card;
the CPU is used only when the caller passes `device="cpu"`.  Discrete
halos (SOURCE_MODEL 'CHMF-SAMPLER' and 'DEXM-ESF': DexM, the CHMF grid
sampler, mass- or number-limited progenitors, the perturbed catalog and its
HaloBox, with the MASS-LIMITED, NUMBER-LIMITED, PARTITION and BINARY-SPLIT
progenitor samplers) run through the same entry points, as do the three
photon-conservation corrections (`setup_photon_cons`) and the global 0-D
history (`run_global_evolution`).  Around them: the HDF5 files of the boxes
and the output cache from which a run resumes (`io`; they need the optional
h5py), the command line (`21cmfast-torch`, `python -m py21cmfast_torch`),
the low-level `cfuncs`, power spectra (`ops.ps`), the UV luminosity
function, the CLASS and Boltzmann helpers, `plotting` (matplotlib, optional)
and the `wrapper` layout of the reference.  Multi-GPU runs (one process a
rank over `torch.distributed`, each on its own x-slab) are in
`py21cmfast_torch.parallel`, which this package does not import.
The swept CIC deposit is a hand-written CUDA kernel
(`csrc/cic_deposit.cu`), built with nvcc at its first use.
"""

__version__ = "0.1.0"

from pathlib import Path as _Path

_DATA_PATH = _Path(__file__).parent / "_data"

from . import interop, lightconers, plotting, wrapper
from ._cfg import config
from ._logging import configure_logging
from ._templates import create_params_from_template, list_templates, write_template
from .cfuncs import compute_luminosity_function, compute_tau
from .cosmology.classy_interface import compute_rms, run_classy
from .drivers.coeval import Coeval, generate_coeval, run_coeval
from .drivers.global_evolution import GlobalEvolution, run_global_evolution
from .drivers.lightcone import LightCone, generate_lightcone, run_lightcone
from .drivers.single_field import interp_halo_boxes
from .exceptions import InfinityOrNaNError, ParameterError
from .io.caching import CacheConfig, OutputCache, RunCache
from .io.h5 import read_inputs, read_output_struct, write_output_to_hdf5
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
from .models.halobox import compute_halo_grid
from .models.halos import determine_halo_catalog, perturb_halo_catalog
from .models.ics import compute_initial_conditions
from .models.ionization import compute_ionization_field
from .models.perturb import perturb_field
from .models.photoncons import setup_photon_cons
from .models.spintemp import compute_spin_temperature
from .models.xray_source import compute_xray_source_field
from .outputs import (
    BrightnessTemp,
    HaloBox,
    HaloCatalog,
    InitialConditions,
    IonizedBox,
    PerturbedField,
    PerturbedHaloCatalog,
    TsBox,
    XraySourceBox,
)

__all__ = [
    "_DATA_PATH",
    "AngularLightconer",
    "AstroOptions",
    "AstroParams",
    "BrightnessTemp",
    "CacheConfig",
    "Coeval",
    "CosmoParams",
    "GlobalEvolution",
    "HaloBox",
    "HaloCatalog",
    "InfinityOrNaNError",
    "InitialConditions",
    "InputParameters",
    "IonizedBox",
    "LightCone",
    "Lightconer",
    "MatterOptions",
    "OutputCache",
    "ParameterError",
    "PerturbedField",
    "PerturbedHaloCatalog",
    "RectilinearLightconer",
    "RunCache",
    "SimulationOptions",
    "TsBox",
    "XraySourceBox",
    "__version__",
    "brightness_temperature",
    "compute_halo_grid",
    "compute_initial_conditions",
    "compute_ionization_field",
    "compute_luminosity_function",
    "compute_rms",
    "compute_spin_temperature",
    "compute_tau",
    "compute_xray_source_field",
    "config",
    "configure_logging",
    "create_params_from_template",
    "determine_halo_catalog",
    "generate_coeval",
    "generate_lightcone",
    "get_logspaced_redshifts",
    "interop",
    "interp_halo_boxes",
    "lightconers",
    "list_templates",
    "perturb_field",
    "perturb_halo_catalog",
    "plotting",
    "read_inputs",
    "read_output_struct",
    "register_class_transfer",
    "run_classy",
    "run_coeval",
    "run_global_evolution",
    "run_lightcone",
    "setup_photon_cons",
    "wrapper",
    "write_output_to_hdf5",
    "write_template",
]
