"""Output field containers: dataclasses of tensors.

Field names follow py21cmfast_tpu/outputs.py (and the reference v4 naming,
outputs.py:508-1707), so a field of one package has the same name in the
other.  Grids are float32 tensors on the run's device; per-snapshot scalars
(redshift, means) are numpy float32 on the host.  `to_numpy()` gives a dict
of numpy arrays that `interop.*_from_numpy` turns back into the struct.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


class _Struct:
    def to_numpy(self) -> dict:
        """Every field as numpy (tensors copied to the host), None kept."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return out


@dataclass(frozen=True)
class InitialConditions(_Struct):
    """Gaussian ICs + (2)LPT displacement fields.

    `vx/vy/vz` are the first-order (Zel'dovich) displacement fields psi in
    comoving Mpc per unit growth factor, sampled on the perturb grid (lowres).
    `*_2LPT` are the second-order fields (Scoccimarro 1998 App. D), to be
    scaled by -3/7 D(z)^2.  Reference: InitialConditions.c:547-772.
    """

    hires_density: torch.Tensor  # (DIM, DIM, D_PARA), delta at z=0 normalization
    lowres_density: torch.Tensor  # (HII_DIM,)*3
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    vx_2LPT: torch.Tensor | None = None
    vy_2LPT: torch.Tensor | None = None
    vz_2LPT: torch.Tensor | None = None
    lowres_vcb: torch.Tensor | None = None


@dataclass(frozen=True)
class PerturbedField(_Struct):
    """Eulerian density and LOS velocity at one redshift (PerturbedField.c:389)."""

    redshift: np.float32
    density: torch.Tensor
    velocity_z: torch.Tensor
    velocity_x: torch.Tensor | None = None
    velocity_y: torch.Tensor | None = None


@dataclass(frozen=True)
class IonizedBox(_Struct):
    """Excursion-set ionization output (IonisationBox.c:1344)."""

    redshift: np.float32
    neutral_fraction: torch.Tensor
    z_reion: torch.Tensor
    ionisation_rate_G12: torch.Tensor
    mean_f_coll: np.float32
    mean_f_coll_MINI: np.float32
    log10_Mturnover_ave: np.float32
    log10_Mturnover_MINI_ave: np.float32
    kinetic_temperature: torch.Tensor | None = None
    mean_free_path: torch.Tensor | None = None
    cumulative_recombinations: torch.Tensor | None = None
    unnormalised_nion: torch.Tensor | None = None
    unnormalised_nion_mini: torch.Tensor | None = None

    @property
    def global_xH(self):
        return float(self.neutral_fraction.double().mean())


@dataclass(frozen=True)
class TsBox(_Struct):
    """Spin temperature output (SpinTemperatureBox.c:87)."""

    redshift: np.float32
    spin_temperature: torch.Tensor
    xray_ionised_fraction: torch.Tensor
    kinetic_temp_neutral: torch.Tensor
    J_21_LW: torch.Tensor | None = None
    J_Lya: torch.Tensor | None = None


@dataclass(frozen=True)
class BrightnessTemp(_Struct):
    """21-cm brightness temperature (BrightnessTemperatureBox.c:22)."""

    redshift: np.float32
    brightness_temp: torch.Tensor
    tau_21: torch.Tensor | None = None

    @property
    def global_Tb(self):
        return float(self.brightness_temp.double().mean())


@dataclass(frozen=True)
class HaloBox(_Struct):
    """Gridded source properties (HaloBox.c:563): comoving densities in
    Msun/Mpc^3 (stars), Msun/s/Mpc^3 (SFR) and 1e38 erg/s/Mpc^3 (X-rays)."""

    redshift: np.float32
    n_ion: torch.Tensor
    halo_sfr: torch.Tensor
    whalo_sfr: torch.Tensor | None = None
    halo_xray: torch.Tensor | None = None
    halo_stars: torch.Tensor | None = None
    halo_sfr_mini: torch.Tensor | None = None
    halo_stars_mini: torch.Tensor | None = None
    count: torch.Tensor | None = None
    log10_Mcrit_ACG_ave: np.float32 | None = None
    log10_Mcrit_MCG_ave: np.float32 | None = None


@dataclass(frozen=True)
class XraySourceBox(_Struct):
    """Pre-filtered SFR/X-ray shells for Ts (SpinTemperatureBox.c:748), each
    stack (N_STEP_TS, HII_DIM, HII_DIM, HII_D_PARA)."""

    redshift: np.float32
    filtered_sfr: torch.Tensor
    filtered_sfr_mini: torch.Tensor | None = None
    filtered_xray: torch.Tensor | None = None
    mean_log10_Mcrit_LW: torch.Tensor | None = None
    # LYA_MULTIPLE_SCATTERING + minihalos: the LW photons travel in straight
    # lines, so the SFR grids are filtered a second time with the plain
    # annulus (SpinTemperatureBox.c:775-783)
    filtered_sfr_lw: torch.Tensor | None = None
    filtered_sfr_mini_lw: torch.Tensor | None = None


@dataclass(frozen=True)
class HaloCatalog(_Struct):
    """Discrete halo catalog (HaloCatalog.c:38), compacted: every entry is a
    halo, `n_halos == len(halo_masses)`.  Masses in Msun, Lagrangian
    coordinates (n, 3) in comoving Mpc, and the three standard-normal draws
    of each halo's stellar, SFR and X-ray scatter, correlated across
    snapshots (Stochasticity.c set_prop_rng:210-232)."""

    redshift: np.float32
    halo_masses: torch.Tensor  # (n,)
    halo_coords: torch.Tensor  # (n, 3)
    star_rng: torch.Tensor
    sfr_rng: torch.Tensor
    xray_rng: torch.Tensor
    n_halos: int

    def to(self, device) -> "HaloCatalog":
        """The catalog with its tensors on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclass(frozen=True)
class PerturbedHaloCatalog(HaloCatalog):
    """Halos moved to their Eulerian positions (PerturbedHaloCatalog.c:25)."""
