"""Physical constants (CGS unless noted).

Mirrors the constant set used by 21cmFAST (reference: src/py21cmfast/src/Constants.c,
values themselves from astropy v7.1 / CODATA), so that parity tests agree at the
1e-7 level.  These are plain Python floats — everything host-side is float64.
"""

from types import SimpleNamespace

physconst = SimpleNamespace(
    # Fundamental constants
    c_cms=2.99792458e10,  # speed of light [cm/s]
    c_kms=2.99792458e5,  # speed of light [km/s]
    h_p=6.62607015e-27,  # Planck constant [erg s]
    k_B=1.380649e-16,  # Boltzmann constant [erg/K]
    m_p=1.67262192369e-24,  # proton mass [g]
    m_e=9.1093837015e-28,  # electron mass [g]
    G=6.6743e-8,  # Newton G [cgs]
    e_charge=4.803204712570263e-10,  # electron charge [esu]
    vac_perm=8.8541878128e-12,  # vacuum permittivity [F/m]
    # Units
    Msun=1.989e33,  # solar mass [g]
    s_per_yr=31556925.9747,  # seconds per year
    cm_per_Mpc=3.08567758e24,  # cm per Mpc
    eV_to_Hz=2.417989e14,  # eV -> Hz
    # Photon frequencies and temperatures
    nu_ion_HI=3.288465e15,  # HI ionization frequency [Hz]
    nu_ion_HeI=5.945836e15,  # HeI ionization frequency [Hz]
    nu_ion_HeII=1.3153862e16,  # HeII ionization frequency [Hz]
    nu_LW_thresh=2.70331197e15,  # Lyman-Werner threshold [Hz]
    nu_Ly_alpha=2.46606727e15,  # Lyman-alpha frequency [Hz]
    T_cmb=2.7255,  # CMB temperature at z=0 [K]
    T_21=0.0682,  # 21cm photon temperature [K]
    lambda_21=21.106114054160,  # 21cm wavelength [cm]
    lambda_Ly_alpha=1215.67,  # [Angstrom]
    lambda_Ly_beta=1025.18,  # [Angstrom]
    lambda_Ly_gamma=972.02,  # [Angstrom]
    # Cross sections and rates
    sigma_T=6.6524587321e-25,  # Thomson cross-section [cm^2]
    sigma_HI=6.3e-18,  # HI photoionization cross-section at 13.6 eV [cm^2]
    A10=2.85e-15,  # 21cm spontaneous emission [1/s]
    A_Ly_alpha=6.24e8,  # Ly-a spontaneous emission [1/s]
    f_alpha=0.4162,  # Ly-a oscillator strength
    alpha_A_10k=4.18e-13,  # case-A recombination at 1e4 K [cm^3/s]
    alpha_B_10k=2.59e-13,  # case-B recombination at 1e4 K [cm^3/s]
    alpha_B_20k=2.52e-13,  # case-B recombination at 2e4 K [cm^3/s]
    # misc
    l_factor=0.620350491,  # (4 pi / 3)^(-1/3): cube length <-> filter radius
    delta_c_sph=1.686,  # spherical-collapse critical overdensity
    delta_c_delos=1.5,  # Delos 2023 random-walk barrier
)

# Derived helper used in a few places: Hubble in 1/s for H0=100h km/s/Mpc
H0_PER_h = 3.2407e-18  # s^-1, matches reference `Ho` macro

TINY = 1e-30
FRACT_FLOAT_ERR = 1e-7
