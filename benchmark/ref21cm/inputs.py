"""Input parameter system.

TPU-native re-design of the reference parameter layer
(`src/py21cmfast/wrapper/inputs.py`): the same five frozen parameter structs and
the composing `InputParameters`, but with no C-struct mirroring — parameters feed
jitted JAX kernels either as static (hashable) config or as device arrays.

Conventions kept from the reference API:
 * log10-valued astro parameters (F_STAR10, M_TURN, L_X, ...) are *stored* as
   given (log10) and exposed in linear units via the ``.cdict``-style
   properties on :class:`AstroParams` (fstar_10, m_turn, ...).
 * choice parameters are strings, validated against the reference option sets.
 * ``SimulationOptions.DIM`` defaults to ``3 * HII_DIM`` (reference
   inputs.py:1014).
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from pathlib import Path

import attrs
import numpy as np
from attrs import field, validators

from .cosmology import Cosmology
from .cosmology.constants import physconst

__all__ = [
    "CosmoParams",
    "MatterOptions",
    "SimulationOptions",
    "AstroOptions",
    "AstroParams",
    "InputParameters",
    "register_class_transfer",
]


def _choice(options, default):
    return field(
        default=default,
        validator=validators.in_(options),
        converter=lambda s: str(s).upper() if isinstance(s, str) else s,
    )


def _choice_nocase(options, default):
    return field(default=default, validator=validators.in_(options))


HMF_OPTIONS = ("PS", "ST", "WATSON", "WATSON-Z", "DELOS", "REED07", "YUNG24")
PS_OPTIONS = ("EH", "BBKS", "EFSTATHIOU", "PEEBLES", "WHITE", "CLASS")
FILTER_OPTIONS = ("SPHERICAL-TOPHAT", "SHARP-K", "GAUSSIAN")
SOURCE_MODELS = ("CONST-ION-EFF", "E-INTEGRAL", "L-INTEGRAL", "DEXM-ESF", "CHMF-SAMPLER")
PERTURB_OPTIONS = ("LINEAR", "ZELDOVICH", "2LPT")
SAMPLE_METHODS = ("MASS-LIMITED", "NUMBER-LIMITED", "PARTITION", "BINARY-SPLIT")
INTEGRATION_METHODS = ("GSL-QAG", "GAUSS-LEGENDRE", "GAMMA-APPROX")
RECOMB_MODELS = ("NONE", "HOMOGENEOUS", "INHOMOGENEOUS")
PHOTON_CONS_TYPES = ("NO-PHOTONCONS", "Z-PHOTONCONS", "ALPHA-PHOTONCONS", "F-PHOTONCONS")
VCB_MODELS = ("NONE", "AVG-AUTO", "FLUCTS", "AVG-DEBUG")
INTERP_TABLE_OPTIONS = ("NO-INTERPOLATION", "SIGMA-INTERPOLATION", "HMF-INTERPOLATION")

_FILTER_TO_INT = {"SPHERICAL-TOPHAT": 0, "SHARP-K": 1, "GAUSSIAN": 2}
_PS_TO_INT = {n: i for i, n in enumerate(PS_OPTIONS)}


@attrs.frozen(kw_only=True)
class CosmoParams:
    """Cosmological parameters (defaults: Planck18 TT,TE,EE+lowE+lensing+BAO)."""

    SIGMA_8: float | None = field(default=None)
    A_s: float | None = field(default=None)
    hlittle: float = field(default=0.6766, converter=float)
    OMm: float = field(default=0.30966, converter=float)
    OMb: float = field(default=0.04897, converter=float)
    POWER_INDEX: float = field(default=0.9665, converter=float)
    OMn: float = field(default=0.0, converter=float)
    OMk: float = field(default=0.0, converter=float)
    OMr: float = field(default=8.6e-5, converter=float)
    OMtot: float = field(default=1.0, converter=float)
    Y_He: float = field(default=0.24, converter=float)
    wl: float = field(default=-1.0, converter=float)

    def __attrs_post_init__(self):
        if self.SIGMA_8 is not None and self.A_s is not None:
            raise ValueError("Cannot set both SIGMA_8 and A_s")

    @property
    def OMl(self) -> float:
        return 1.0 - self.OMm - self.OMk

    # Planck18 consistent normalization pair (reference inputs.py:492-493)
    _DEFAULT_SIGMA_8 = 0.8102
    _DEFAULT_A_s = 2.105e-9

    @property
    def sigma_8_effective(self) -> float:
        """SIGMA_8, derived from A_s when only A_s is given.

        The reference derives SIGMA_8 from A_s by running CLASS
        (inputs.py:553-572); classy is absent here, so use the Planck18
        consistent pair with the sigma8 ∝ sqrt(A_s) scaling (exact for a
        fixed transfer function / cosmology)."""
        if self.SIGMA_8 is not None:
            return self.SIGMA_8
        if self.A_s is not None:
            return self._DEFAULT_SIGMA_8 * float(np.sqrt(self.A_s / self._DEFAULT_A_s))
        return self._DEFAULT_SIGMA_8

    @property
    def cosmo(self):
        """An astropy-free stand-in: the host-side Cosmology for this param set."""
        return self.cosmology()

    def cosmology(self, power_spectrum: int = 0, transfer_table=None,
                  vcb_suppression: bool = False) -> Cosmology:
        # The reference ALWAYS normalizes by sigma8 for non-CLASS transfer
        # functions (inputs.py:1963-1966: the A_s convention is only
        # meaningful with dimensionful CLASS transfer tables); A_s-given runs
        # are converted through sigma_8_effective above.
        use_as = self.A_s is not None and power_spectrum == _PS_TO_INT["CLASS"]
        return Cosmology(
            hlittle=self.hlittle,
            OMm=self.OMm,
            OMb=self.OMb,
            OMn=self.OMn,
            OMr=self.OMr,
            OMk=self.OMk,
            POWER_INDEX=self.POWER_INDEX,
            SIGMA_8=None if use_as else self.sigma_8_effective,
            A_s=self.A_s if use_as else None,
            Y_He=self.Y_He,
            wl=self.wl,
            power_spectrum=power_spectrum,
            transfer_table=transfer_table,
            vcb_suppression=vcb_suppression,
        )

    @property
    def RHOcrit(self) -> float:
        """Critical density [Msun/Mpc^3]."""
        Ho = self.hlittle * 3.2407e-18
        return (
            (3.0 * Ho**2 / (8.0 * np.pi * physconst.G))
            * physconst.cm_per_Mpc**3
            / physconst.Msun
        )

    asdict = attrs.asdict


@attrs.frozen(kw_only=True)
class MatterOptions:
    """Flags controlling the matter-field part of the simulation."""

    HMF: str = _choice(HMF_OPTIONS, "ST")
    POWER_SPECTRUM: str = _choice(PS_OPTIONS, "EH")
    V_CB_MODEL: str = _choice(VCB_MODELS, "NONE")
    PERTURB_ON_HIGH_RES: bool = field(default=False, converter=bool)
    # CIC deposit implementation: "SWEPT" = scatter-free axis transports
    # (ops/deposit.py; ~20x faster on TPU, exact positions with
    # operator-split lateral-displacement merging), "SCATTER" = per-particle
    # scatter-adds (bitwise reference semantics).  SWEPT falls back to
    # SCATTER automatically when its layout requirements don't hold
    # (PERTURB_ON_HIGH_RES, non-integer DIM/HII_DIM).
    PERTURB_DEPOSIT: str = _choice(("SWEPT", "SCATTER"), "SWEPT")
    USE_INTERPOLATION_TABLES: str = _choice(INTERP_TABLE_OPTIONS, "HMF-INTERPOLATION")
    MINIMIZE_MEMORY: bool = field(default=False, converter=bool)
    KEEP_3D_VELOCITIES: bool = field(default=False, converter=bool)
    SAMPLE_METHOD: str = _choice(SAMPLE_METHODS, "MASS-LIMITED")
    FILTER: str = _choice(FILTER_OPTIONS, "SPHERICAL-TOPHAT")
    HALO_FILTER: str = _choice(FILTER_OPTIONS, "SPHERICAL-TOPHAT")
    SMOOTH_EVOLVED_DENSITY_FIELD: bool = field(default=False, converter=bool)
    DEXM_OPTIMIZE: bool = field(default=False, converter=bool)
    PERTURB_ALGORITHM: str = _choice(PERTURB_OPTIONS, "2LPT")
    USE_FFTW_WISDOM: bool = field(default=False, converter=bool)  # accepted, unused on TPU
    SOURCE_MODEL: str = _choice(SOURCE_MODELS, "CHMF-SAMPLER")

    def __attrs_post_init__(self):
        # NOTE: the reference requires POWER_SPECTRUM='CLASS' for
        # V_CB_MODEL='FLUCTS' (inputs.py validators + cosmology.c:310); here an
        # analytic acoustic P_vcb (Cosmology.power_vcb) serves as the default,
        # and a CLASS table can be injected via Cosmology.set_vcb_power_table.
        if self.FILTER == "SHARP-K":
            raise ValueError("FILTER cannot be sharp-k (no M<->R conversion)")

    @property
    def filter_int(self) -> int:
        return _FILTER_TO_INT[self.FILTER]

    @property
    def halo_filter_int(self) -> int:
        return _FILTER_TO_INT[self.HALO_FILTER]

    @property
    def power_spectrum_int(self) -> int:
        return _PS_TO_INT[self.POWER_SPECTRUM]

    @property
    def source_model_is_mass_dependent(self) -> bool:
        return self.SOURCE_MODEL in ("E-INTEGRAL", "L-INTEGRAL", "DEXM-ESF", "CHMF-SAMPLER")

    @property
    def source_model_uses_lagrangian_grids(self) -> bool:
        return self.SOURCE_MODEL in ("L-INTEGRAL", "DEXM-ESF", "CHMF-SAMPLER")

    @property
    def source_model_uses_halo_sampler(self) -> bool:
        return self.SOURCE_MODEL in ("DEXM-ESF", "CHMF-SAMPLER")


@attrs.frozen(kw_only=True)
class SimulationOptions:
    """Box dimensions, redshift stepping and sampler knobs."""

    HII_DIM: int = field(default=256, converter=int)
    BOX_LEN: float | None = field(default=None)
    DIM: int | None = field(default=None)
    HIRES_TO_LOWRES_FACTOR: float | None = field(default=None)
    LOWRES_CELL_SIZE_MPC: float | None = field(default=None)
    NON_CUBIC_FACTOR: float = field(default=1.0, converter=float)
    N_THREADS: int = field(default=1, converter=int)  # accepted, unused on TPU
    SAMPLER_MIN_MASS: float = field(default=1e8, converter=float)
    SAMPLER_BUFFER_FACTOR: float = field(default=2.0, converter=float)
    N_COND_INTERP: int = field(default=200, converter=int)
    N_PROB_INTERP: int = field(default=400, converter=int)
    MIN_LOGPROB: float = field(default=-12, converter=float)
    # NOTE: the reference defaults this to 0.89 to compensate its
    # keep-the-overshoot sampling bias (Stochasticity.c:376-381); our sampler
    # stops with an exactly-unbiased probabilistic crossing rule, so no
    # correction is needed by default.
    # multiplies the expected mass of mass-limited halo sampling; the
    # reference default 0.89 compensates the sampling loop's overshoot bias
    # (reference inputs.py:953-1050, Stochasticity.c:377-380)
    HALOMASS_CORRECTION: float = field(default=0.89, converter=float)
    # Parkinson+08 EPS-correction parameters for SAMPLE_METHOD='BINARY-SPLIT'
    PARKINSON_G0: float = field(default=1.0, converter=float)
    PARKINSON_y1: float = field(default=0.0, converter=float)
    PARKINSON_y2: float = field(default=0.0, converter=float)
    PARKINSON_G0: float = field(default=1.0, converter=float)
    PARKINSON_y1: float = field(default=0.0, converter=float)
    PARKINSON_y2: float = field(default=0.0, converter=float)
    Z_HEAT_MAX: float = field(default=35.0, converter=float)
    ZPRIME_STEP_FACTOR: float = field(default=1.02, converter=float)
    MIN_XE_FOR_FCOLL_IN_TAUX: float = field(default=1e-3, converter=float)
    INITIAL_REDSHIFT: float = field(default=300.0, converter=float)
    DELTA_R_FACTOR: float = field(default=1.1, converter=float)
    DENSITY_SMOOTH_RADIUS: float = field(default=0.2, converter=float)
    DEXM_OPTIMIZE_MINMASS: float = field(default=1e11, converter=float)
    DEXM_R_OVERLAP: float = field(default=2, converter=float)
    CORR_STAR: float = field(default=0.5, converter=float)
    CORR_SFR: float = field(default=0.2, converter=float)
    CORR_LX: float = field(default=0.2, converter=float)

    _DEFAULT_HIRES_TO_LOWRES_FACTOR = 3.0
    _DEFAULT_LOWRES_CELL_SIZE_MPC = 1.5

    def __attrs_post_init__(self):
        if self.DIM is not None and self.HIRES_TO_LOWRES_FACTOR is not None:
            raise ValueError("Cannot set both DIM and HIRES_TO_LOWRES_FACTOR")
        if self.BOX_LEN is not None and self.LOWRES_CELL_SIZE_MPC is not None:
            raise ValueError("Cannot set both BOX_LEN and LOWRES_CELL_SIZE_MPC")
        ncf = self.NON_CUBIC_FACTOR
        if (self.dim * ncf) != int(self.dim * ncf) or (self.HII_DIM * ncf) != int(
            self.HII_DIM * ncf
        ):
            raise ValueError("NON_CUBIC_FACTOR must produce integer grid sizes")

    @property
    def hires_to_lowres_factor(self) -> float:
        if self.DIM is not None:
            return self.DIM / self.HII_DIM
        if self.HIRES_TO_LOWRES_FACTOR is not None:
            return self.HIRES_TO_LOWRES_FACTOR
        return self._DEFAULT_HIRES_TO_LOWRES_FACTOR

    @property
    def dim(self) -> int:
        """High-res grid size per side (reference `DIM`)."""
        if self.DIM is not None:
            return int(self.DIM)
        return int(self.HII_DIM * self.hires_to_lowres_factor)

    @property
    def box_len(self) -> float:
        if self.BOX_LEN is not None:
            return float(self.BOX_LEN)
        if self.LOWRES_CELL_SIZE_MPC is not None:
            return round(self.HII_DIM * self.LOWRES_CELL_SIZE_MPC, 3)
        return round(self.HII_DIM * self._DEFAULT_LOWRES_CELL_SIZE_MPC, 3)

    # grid helpers
    @property
    def d_para(self) -> int:
        return int(self.NON_CUBIC_FACTOR * self.dim)

    @property
    def hii_d_para(self) -> int:
        return int(self.NON_CUBIC_FACTOR * self.HII_DIM)

    @property
    def hires_shape(self) -> tuple[int, int, int]:
        return (self.dim, self.dim, self.d_para)

    @property
    def lowres_shape(self) -> tuple[int, int, int]:
        return (self.HII_DIM, self.HII_DIM, self.hii_d_para)

    @property
    def box_lens(self) -> tuple[float, float, float]:
        return (self.box_len, self.box_len, self.box_len * self.NON_CUBIC_FACTOR)

    @property
    def volume(self) -> float:
        return self.box_len**3 * self.NON_CUBIC_FACTOR

    @property
    def tot_num_pixels(self) -> int:
        return int(np.prod(self.hires_shape))

    @property
    def hii_tot_num_pixels(self) -> int:
        return int(np.prod(self.lowres_shape))

    def cell_size(self, lowres=True) -> float:
        return self.box_len / (self.HII_DIM if lowres else self.dim)


@attrs.frozen(kw_only=True)
class AstroOptions:
    """Flags controlling astrophysics & radiation."""

    USE_MINI_HALOS: bool = field(default=False, converter=bool)
    USE_X_RAY_HEATING: bool = field(default=True, converter=bool)
    USE_CMB_HEATING: bool = field(default=True, converter=bool)
    USE_ADIABATIC_FLUCTUATIONS: bool = field(default=True, converter=bool)
    USE_LYA_HEATING: bool = field(default=True, converter=bool)
    USE_TS_FLUCT: bool = field(default=False, converter=bool)
    USE_EXP_FILTER: bool = field(default=True, converter=bool)
    CELL_RECOMB: bool = field(default=True, converter=bool)
    USE_UPPER_STELLAR_TURNOVER: bool = field(default=True, converter=bool)
    # Lya multiple-scattering window (filter 5, arXiv:2601.14360) for the
    # XraySourceBox SFR shells; only meaningful for Lagrangian source models
    # (reference _inputparams_wrapper.h:150, SpinTemperatureBox.c:753)
    LYA_MULTIPLE_SCATTERING: bool = field(default=False, converter=bool)
    M_MIN_in_Mass: bool = field(default=True, converter=bool)
    HALO_SCALING_RELATIONS_MEDIAN: bool = field(default=False, converter=bool)
    IONISE_ENTIRE_SPHERE: bool = field(default=False, converter=bool)
    FIX_VCB_AVG: bool = field(default=False, converter=bool)
    HII_FILTER: str = _choice(FILTER_OPTIONS, "SPHERICAL-TOPHAT")
    HEAT_FILTER: str = _choice(FILTER_OPTIONS, "SPHERICAL-TOPHAT")
    RECOMB_MODEL: str = _choice(RECOMB_MODELS, "NONE")
    INTEGRATION_METHOD_ATOMIC: str = _choice(INTEGRATION_METHODS, "GAUSS-LEGENDRE")
    INTEGRATION_METHOD_MINI: str = _choice(INTEGRATION_METHODS, "GAUSS-LEGENDRE")
    PHOTON_CONS_TYPE: str = _choice(PHOTON_CONS_TYPES, "NO-PHOTONCONS")

    def __attrs_post_init__(self):
        if self.USE_EXP_FILTER and self.HII_FILTER != "SPHERICAL-TOPHAT":
            raise ValueError("USE_EXP_FILTER requires a real-space tophat HII_FILTER")
        if self.USE_MINI_HALOS and self.PHOTON_CONS_TYPE == "Z-PHOTONCONS":
            raise ValueError("z-photoncons incompatible with USE_MINI_HALOS")

    @property
    def hii_filter_int(self) -> int:
        return _FILTER_TO_INT[self.HII_FILTER]

    @property
    def heat_filter_int(self) -> int:
        return _FILTER_TO_INT[self.HEAT_FILTER]

    @property
    def uses_recombination(self) -> bool:
        return self.RECOMB_MODEL != "NONE"

    @property
    def INHOMO_RECO(self) -> bool:
        return self.RECOMB_MODEL == "INHOMOGENEOUS"


@attrs.frozen(kw_only=True)
class AstroParams:
    """Astrophysical parameters.

    Log10-defined parameters follow the reference convention: the *stored*
    attribute is log10 of the physical value (e.g. ``F_STAR10=-1.3`` means
    :math:`f_{*,10} = 10^{-1.3}`); the linear value is available as the
    lowercase property (``fstar_10``).
    """

    HII_EFF_FACTOR: float = field(default=30.0, converter=float)
    F_STAR10: float = field(default=-1.3, converter=float)  # log10
    ALPHA_STAR: float = field(default=0.5, converter=float)
    F_STAR7_MINI: float | None = field(default=None)  # log10; default derived
    ALPHA_STAR_MINI: float | None = field(default=None)
    F_ESC10: float = field(default=-1.0, converter=float)  # log10
    ALPHA_ESC: float = field(default=-0.5, converter=float)
    F_ESC7_MINI: float = field(default=-2.0, converter=float)  # log10
    M_TURN: float = field(default=8.7, converter=float)  # log10 Msun
    R_BUBBLE_MAX: float | None = field(default=None)  # Mpc; default depends on recomb
    R_BUBBLE_MIN: float = field(default=physconst.l_factor, converter=float)
    ION_Tvir_MIN: float = field(default=4.69897, converter=float)  # log10 K
    L_X: float = field(default=40.5, converter=float)  # log10 erg/s/SFR
    L_X_MINI: float | None = field(default=None)  # log10; defaults to L_X
    NU_X_THRESH: float = field(default=500.0, converter=float)  # eV
    X_RAY_SPEC_INDEX: float = field(default=1.0, converter=float)
    X_RAY_Tvir_MIN: float | None = field(default=None)  # log10 K; defaults ION_Tvir_MIN
    F_H2_SHIELD: float = field(default=0.0, converter=float)
    t_STAR: float = field(default=0.5, converter=float)
    A_LW: float = field(default=2.0, converter=float)
    BETA_LW: float = field(default=0.6, converter=float)
    A_VCB: float = field(default=1.0, converter=float)
    BETA_VCB: float = field(default=1.8, converter=float)
    UPPER_STELLAR_TURNOVER_MASS: float = field(default=11.447, converter=float)  # log10
    UPPER_STELLAR_TURNOVER_INDEX: float = field(default=-0.6, converter=float)
    SIGMA_STAR: float = field(default=0.25, converter=float)
    SIGMA_LX: float = field(default=0.5, converter=float)
    SIGMA_SFR_LIM: float = field(default=0.19, converter=float)
    SIGMA_SFR_INDEX: float = field(default=-0.12, converter=float)
    T_RE: float = field(default=2e4, converter=float)
    # reference default V_CB_AVG_DEFAULT=27.0 (wrapper/inputs.py:138,1734-1737)
    V_CB_AVG_DEBUG: float = field(default=27.0, converter=float)
    POP2_ION: float = field(default=5000.0, converter=float)
    POP3_ION: float = field(default=44021.0, converter=float)
    PHOTONCONS_CALIBRATION_END: float = field(default=3.5, converter=float)
    CLUMPING_FACTOR: float = field(default=2.0, converter=float)
    ALPHA_UVB: float = field(default=5.0, converter=float)
    R_MAX_TS: float = field(default=500.0, converter=float)
    N_STEP_TS: int = field(default=40, converter=int)
    MAX_DVDR: float = field(default=0.2, converter=float)
    DELTA_R_HII_FACTOR: float = field(default=1.1, converter=float)
    NU_X_BAND_MAX: float = field(default=2000.0, converter=float)
    NU_X_MAX: float = field(default=10000.0, converter=float)

    # --- linear-unit accessors -------------------------------------------
    @property
    def fstar_10(self):
        return 10.0**self.F_STAR10

    @property
    def fstar_7(self):
        # default continues the ACG power law down to 1e7 Msun:
        # F_STAR10 - 3*ALPHA_STAR in log10, since 1e7/1e10 = 1e-3
        # (reference inputs.py:1685-1687 _F_STAR7_MINI_default)
        f = (
            self.F_STAR7_MINI
            if self.F_STAR7_MINI is not None
            else self.F_STAR10 - 3.0 * self.ALPHA_STAR
        )
        return 10.0**f

    @property
    def alpha_star_mini(self):
        return self.ALPHA_STAR_MINI if self.ALPHA_STAR_MINI is not None else self.ALPHA_STAR

    @property
    def fesc_10(self):
        return 10.0**self.F_ESC10

    @property
    def fesc_7(self):
        return 10.0**self.F_ESC7_MINI

    @property
    def m_turn(self):
        return 10.0**self.M_TURN

    @property
    def ion_tvir_min(self):
        return 10.0**self.ION_Tvir_MIN

    @property
    def x_ray_tvir_min(self):
        t = self.X_RAY_Tvir_MIN if self.X_RAY_Tvir_MIN is not None else self.ION_Tvir_MIN
        return 10.0**t

    @property
    def l_x(self):
        return 10.0**self.L_X

    @property
    def l_x_mini(self):
        lx = self.L_X_MINI if self.L_X_MINI is not None else self.L_X
        return 10.0**lx

    @property
    def upper_stellar_turnover_mass(self):
        return 10.0**self.UPPER_STELLAR_TURNOVER_MASS

    def r_bubble_max(self, astro_options: AstroOptions) -> float:
        """Max filter radius. Reference default: 15 Mpc, or 50 Mpc with INHOMO_RECO."""
        if self.R_BUBBLE_MAX is not None:
            return float(self.R_BUBBLE_MAX)
        return 50.0 if astro_options.RECOMB_MODEL == "INHOMOGENEOUS" else 15.0


@attrs.frozen(kw_only=True)
class InputParameters:
    """The full, validated set of inputs for a simulation run."""

    random_seed: int = field(converter=int)
    cosmo_params: CosmoParams = field(factory=CosmoParams)
    matter_options: MatterOptions = field(factory=MatterOptions)
    simulation_options: SimulationOptions = field(factory=SimulationOptions)
    astro_options: AstroOptions = field(factory=AstroOptions)
    astro_params: AstroParams = field(factory=AstroParams)
    node_redshifts: tuple = field(default=(), converter=tuple)

    def __attrs_post_init__(self):
        """Cross-group validation (reference inputs.py:1971-2134)."""
        import warnings

        mo, so, ao, ap = (
            self.matter_options, self.simulation_options,
            self.astro_options, self.astro_params,
        )
        if ao.USE_MINI_HALOS:
            if mo.SOURCE_MODEL == "CONST-ION-EFF":
                raise ValueError(
                    "SOURCE_MODEL='CONST-ION-EFF' is not compatible with "
                    "USE_MINI_HALOS=True"
                )
            if mo.V_CB_MODEL == "NONE":
                warnings.warn(
                    "USE_MINI_HALOS needs a non-trivial V_CB_MODEL to get the "
                    "right evolution!",
                    stacklevel=2,
                )
        elif mo.V_CB_MODEL != "NONE":
            warnings.warn(
                "USE_MINI_HALOS is False but V_CB_MODEL != 'NONE'; relative "
                "velocities only matter with mini-halos present",
                stacklevel=2,
            )

        if mo.source_model_uses_lagrangian_grids:
            if ao.PHOTON_CONS_TYPE == "Z-PHOTONCONS":
                raise ValueError(
                    f"SOURCE_MODEL={mo.SOURCE_MODEL} is not compatible with "
                    "redshift-based photon conservation (PHOTON_CONS_TYPE="
                    "'z-photoncons'); use another PHOTON_CONS_TYPE or "
                    "SOURCE_MODEL='E-INTEGRAL'"
                )
        else:
            if ao.USE_EXP_FILTER:
                raise ValueError(
                    f"USE_EXP_FILTER is not compatible with SOURCE_MODEL="
                    f"{mo.SOURCE_MODEL}"
                )
            if ao.LYA_MULTIPLE_SCATTERING:
                raise ValueError(
                    f"LYA_MULTIPLE_SCATTERING is not compatible with "
                    f"SOURCE_MODEL={mo.SOURCE_MODEL}"
                )
        if not mo.source_model_uses_halo_sampler and ao.USE_UPPER_STELLAR_TURNOVER:
            # NOTE: the reference raises NotImplementedError here; our integral
            # paths simply omit the upper turnover, so a warning suffices
            warnings.warn(
                "USE_UPPER_STELLAR_TURNOVER only affects discrete-halo source "
                f"models; it is ignored for SOURCE_MODEL={mo.SOURCE_MODEL}",
                stacklevel=2,
            )
        if mo.HMF not in ("PS", "ST", "DELOS"):
            warnings.warn(
                f"HMF={mo.HMF} has no conditional form: the EPS conditional "
                "MF is used, mean-normalized to the chosen unconditional MF",
                stacklevel=2,
            )
        if (
            "GAMMA-APPROX" in (ao.INTEGRATION_METHOD_ATOMIC, ao.INTEGRATION_METHOD_MINI)
            and mo.HMF != "PS"
        ):
            # reference inputs.py:2053-2063: the gamma approximation is EPS-only
            warnings.warn(
                "INTEGRATION_METHOD GAMMA-APPROX uses the EPS conditional mass "
                f"function even though HMF={mo.HMF}",
                stacklevel=2,
            )

        r_max = ap.r_bubble_max(ao)
        if so.HII_DIM > 1 and r_max > so.box_len:
            raise ValueError(
                f"R_BUBBLE_MAX is larger than BOX_LEN ({r_max} > {so.box_len})"
            )
        if so.HII_DIM > 1 and ao.HII_FILTER == "SHARP-K" and r_max > so.box_len / 3:
            raise ValueError(
                f"R_BUBBLE_MAX > BOX_LEN/3 ({r_max} > {so.box_len / 3:.1f}) "
                "with a sharp-k filter can produce strange reionization topologies"
            )
        if (
            ap.R_BUBBLE_MAX is not None
            and ap.R_BUBBLE_MAX != 50
            and ao.RECOMB_MODEL != "NONE"
        ):
            warnings.warn(
                "R_BUBBLE_MAX != 50 with recombinations enabled is "
                "non-standard (but allowed)",
                stacklevel=2,
            )
        if ao.USE_MINI_HALOS and ap.M_TURN > 8:
            warnings.warn(
                "M_TURN > 8 with USE_MINI_HALOS=True is non-standard (but allowed)",
                stacklevel=2,
            )
        if (
            so.box_len / so.dim > 1.0
            and mo.PERTURB_ALGORITHM != "LINEAR"
        ):
            warnings.warn(
                "hires resolution is likely too low for accurate evolved "
                f"density fields (cell {so.box_len / so.dim:.2f} Mpc); increase "
                "DIM or use PERTURB_ALGORITHM='LINEAR'",
                stacklevel=2,
            )

    # deprecated field name -> (new name, value transform) — reference
    # inputs.py:819-840 (USE_RELATIVE_VELOCITIES, v4.3), :1336-1365
    # (INHOMO_RECO, v4.2), :1540-1735 (FIXED_VAVG)
    _DEPRECATED_ALIASES = {
        "USE_RELATIVE_VELOCITIES": (
            "V_CB_MODEL", lambda v: "FLUCTS" if v else "NONE"
        ),
        "INHOMO_RECO": (
            "RECOMB_MODEL", lambda v: "INHOMOGENEOUS" if v else "NONE"
        ),
        "FIXED_VAVG": ("V_CB_AVG_DEBUG", lambda v: v),
    }

    def evolve_input_structs(self, **kwargs) -> "InputParameters":
        """Return a copy with the given (flat) field overrides applied, mirroring
        the reference ``InputParameters.evolve_input_structs`` (including its
        deprecated-name shims)."""
        import warnings

        for old, (new_name, transform) in self._DEPRECATED_ALIASES.items():
            if old in kwargs:
                kwargs = dict(kwargs)
                val = kwargs.pop(old)
                warnings.warn(
                    f"{old} is deprecated and will be removed in a future "
                    f"version; use {new_name} instead",
                    DeprecationWarning,
                    stacklevel=2,
                )
                kwargs.setdefault(new_name, transform(val))
        groups = {
            "cosmo_params": self.cosmo_params,
            "matter_options": self.matter_options,
            "simulation_options": self.simulation_options,
            "astro_options": self.astro_options,
            "astro_params": self.astro_params,
        }
        updates = {k: {} for k in groups}
        top = {}
        # convenience reconciliation: switching to an Eulerian source model
        # implies the halo-only filter flags go off unless explicitly given
        # (the reference forces users to set them; here the common intent is
        # honored and the cross-validators still reject explicit conflicts)
        new_sm = kwargs.get("SOURCE_MODEL")
        if new_sm is not None:
            new_sm = str(new_sm).upper()
            kwargs = dict(kwargs)
            if new_sm in ("CONST-ION-EFF", "E-INTEGRAL"):
                kwargs.setdefault("USE_EXP_FILTER", False)
                kwargs.setdefault("LYA_MULTIPLE_SCATTERING", False)
            if new_sm not in ("CHMF-SAMPLER", "DEXM-ESF"):
                kwargs.setdefault("USE_UPPER_STELLAR_TURNOVER", False)
        for key, val in kwargs.items():
            placed = False
            for gname, g in groups.items():
                if key in {f.name for f in attrs.fields(type(g))}:
                    updates[gname][key] = val
                    placed = True
                    break
            if not placed:
                if key in ("random_seed", "node_redshifts"):
                    top[key] = val
                else:
                    raise ValueError(f"Unknown parameter: {key}")
        new = {g: attrs.evolve(obj, **updates[g]) for g, obj in groups.items() if updates[g]}
        return attrs.evolve(self, **new, **top)

    def with_logspaced_redshifts(self, zmin: float, zmax: float | None = None):
        """Fill node_redshifts with the standard (1+z) log spacing, descending."""
        zmax = zmax if zmax is not None else self.simulation_options.Z_HEAT_MAX
        step = self.simulation_options.ZPRIME_STEP_FACTOR
        return attrs.evolve(
            self, node_redshifts=get_logspaced_redshifts(zmin, step, zmax)
        )

    # convenience accessors used everywhere in the model layer
    @property
    def cosmology(self) -> Cosmology:
        return _cached_cosmology(
            self.cosmo_params,
            self.matter_options.power_spectrum_int,
            _class_transfer["version"],
            uses_vcb=self.matter_options.V_CB_MODEL != "NONE",
        )

    def _hash_of(self, *groups) -> str:
        h = hashlib.md5()
        for g in groups:
            h.update(repr(g).encode())
        return h.hexdigest()

    @property
    def matter_cosmo_hash(self) -> str:
        return self._hash_of(
            self.cosmo_params, self.matter_options, self.simulation_options
        )

    @property
    def astro_hash(self) -> str:
        return self._hash_of(self.astro_params, self.astro_options)

    @property
    def zgrid_hash(self) -> str:
        return self._hash_of(self.node_redshifts)

    @property
    def full_hash(self) -> str:
        return self._hash_of(
            self.cosmo_params,
            self.matter_options,
            self.simulation_options,
            self.astro_options,
            self.astro_params,
            self.random_seed,
            self.node_redshifts,
        )


# externally-computed CLASS transfer tables (the reference runs classy at
# runtime, wrapper/classy_interface.py; classy is not bundled here, so the
# user registers the tables once per process)
def get_logspaced_redshifts(
    min_redshift: float, z_step_factor: float, max_redshift: float
) -> tuple[float, ...]:
    """Log-spaced (1+z) redshift ladder, descending (reference
    wrapper/inputs.py:1774-1789 `get_logspaced_redshifts`)."""
    zs = []
    z = float(min_redshift)
    while z < max_redshift:
        zs.append(z)
        z = (1 + z) * z_step_factor - 1
    zs.append(z)
    return tuple(sorted(zs, reverse=True))


_class_transfer = {"version": 0, "density": None, "vcb": None}


def register_class_transfer(k, transfer_density, k_vcb=None, transfer_vcb=None):
    """Register CLASS transfer-function tables for POWER_SPECTRUM='CLASS'.

    `transfer_density` follows the CLASS convention (T ~ delta(k, z=0)/zeta(k),
    so T ~ k^2 at low k); `transfer_vcb` (optional) is the relative-velocity
    transfer in units of v/c, as ingested by the reference
    (cosmology.c:310 power_in_vcb)."""
    _class_transfer["density"] = (
        np.asarray(k, np.float64), np.asarray(transfer_density, np.float64)
    )
    if transfer_vcb is not None:
        _class_transfer["vcb"] = (
            np.asarray(k_vcb if k_vcb is not None else k, np.float64),
            np.asarray(transfer_vcb, np.float64),
        )
    _class_transfer["version"] += 1
    _cached_cosmology.cache_clear()


def _bundled_class_transfer(cosmo_params: CosmoParams, kind: str = "density"):
    """The packaged Planck18 CLASS-convention transfer tables
    (_data/class_transfer_{density,vcb}_planck18.dat; provenance in their
    headers and _data/README.md) — valid only for the default cosmology,
    checked here to 0.1%.  Returns (k, T) or None."""
    defaults = CosmoParams()
    for attr in ("hlittle", "OMm", "OMb", "POWER_INDEX"):
        a, b = float(getattr(cosmo_params, attr)), float(getattr(defaults, attr))
        if abs(a - b) > 1e-3 * max(abs(b), 1e-10):
            return None
    path = Path(__file__).parent / "_data" / f"class_transfer_{kind}_planck18.dat"
    if not path.exists():
        return None
    dat = np.loadtxt(path)
    return dat[:, 0].copy(), dat[:, 1].copy()


@lru_cache(maxsize=8)
def _cached_cosmology(cosmo_params: CosmoParams, ps_int: int, _v: int = 0,
                      uses_vcb: bool = False) -> Cosmology:
    # sigma_norm quadrature is the expensive part; cache per parameter set
    table = None
    if ps_int == 5:
        table = _class_transfer["density"]
        if table is None:
            # fall back to the packaged default-cosmology table (the
            # reference runs classy live, wrapper/inputs.py:1861-1966;
            # classy is not in this image so the deterministic default
            # table ships as package data, like recfast_LCDM.dat)
            table = _bundled_class_transfer(cosmo_params)
        if table is None:
            raise ValueError(
                "POWER_SPECTRUM='CLASS' needs transfer tables for a "
                "non-default cosmology: call "
                "py21cmfast_torch.register_class_transfer(k, T[, k_vcb, T_vcb]) "
                "with the output of a CLASS run (the in-house Boltzmann solver "
                "that computes them without classy is not ported to "
                "py21cmfast_torch yet: ROADMAP Queue 1 item 16)"
            )
    cosmo = cosmo_params.cosmology(power_spectrum=ps_int, transfer_table=table,
                                   vcb_suppression=uses_vcb)
    if ps_int == 5:
        vcb_table = _class_transfer["vcb"]
        if vcb_table is None and uses_vcb:
            # packaged Planck18 T_vcb (computed by the in-house Boltzmann
            # solver, scripts/r5_make_vcb_table.py) — the stand-in for the
            # reference's live-CLASS v_cb transfer (wrapper/inputs.py:1915-1935)
            vcb_table = _bundled_class_transfer(cosmo_params, kind="vcb")
        if vcb_table is not None:
            kv, tv = vcb_table
            with np.errstate(divide="ignore", invalid="ignore"):
                p_vcb = (
                    cosmo.sigma_norm
                    * cosmo.primordial_curvature_power(kv)
                    * (tv * physconst.c_cms / 1e5) ** 2
                    / kv**3
                )
            cosmo.set_vcb_power_table(kv, np.where(kv > 0, p_vcb, 0.0))
    return cosmo
