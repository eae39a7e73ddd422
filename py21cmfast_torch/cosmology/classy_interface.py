"""CLASS interface (reference wrapper/classy_interface.py:53-370), following
py21cmfast_tpu/cosmology/classy_interface.py (host numpy, float64).

The reference hard-depends on the `classy` Boltzmann code for transfer
functions, field-rms computations, and the kinematic-decoupling redshift.
Here classy is OPTIONAL:

* with classy installed, `run_classy` mirrors the reference's defaulted
  parameter handling and returns the live `classy.Class` object;
* without it, `compute_rms` / `find_redshift_kinematic_decoupling` fall
  back to this package's own machinery — the active `Cosmology` transfer
  functions (including any table injected via `register_class_transfer`)
  and the bundled RECFAST recombination history — so the public API stays
  importable and usable on a machine without classy.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "run_classy",
    "get_transfer_function",
    "compute_rms",
    "find_redshift_kinematic_decoupling",
]

_not4_ = 3.9715  # mass He / mass H (reference global_params convention)

# CLASS defaults matching the reference classy_params_default
# (classy_interface.py:20-52), without astropy units
_classy_params_default = {
    "output": "mPk, dTk, vTk",
    "A_s": 2.1e-9,
    "sigma8": 0.8102,
    "n_s": 0.9665,
    "h": 0.6766,
    "omega_b": 0.02242,
    "omega_cdm": 0.11933,
    "tau_reio": 0.0554,
    "T_cmb": 2.7255,
    "N_ncdm": 1,
    "m_ncdm": "0.06",
    "N_ur": 2.0308,
    "z_pk": 1087.0,
    "gauge": "Newtonian",
    "P_k_max_1/Mpc": 10.0,
}


def run_classy(**kwargs):
    """Run CLASS with the reference's defaulted parameters
    (reference run_classy, classy_interface.py:53-113).

    Requires the optional `classy` package; raises ImportError with a
    pointer to `register_class_transfer` when it is unavailable.
    """
    try:
        from classy import Class
    except ImportError as e:  # pragma: no cover - classy is optional
        raise ImportError(
            "run_classy requires the optional `classy` package, which is not "
            "installed. Precomputed transfer tables can be supplied instead "
            "via py21cmfast_torch.register_class_transfer(k, T[, k_vcb, T_vcb]) "
            "(the package also ships tabulated default-cosmology transfers in "
            "_data/)."
        ) from e

    params = dict(_classy_params_default)
    if "A_s" not in kwargs:
        params.pop("A_s")
    elif "sigma8" not in kwargs:
        params.pop("sigma8")
    else:
        raise KeyError(
            "Do not provide both 'sigma8' and 'A_s' as arguments. "
            "Only one of them is allowed."
        )
    if ("m_ncdm" in kwargs) and kwargs.get("N_ncdm") == 0:
        raise KeyError("You specified m_ncdm, but set N_ncdm=0.")

    level = kwargs.pop("level", "distortions")
    for k, v in kwargs.items():
        if k == "P_k_max":
            params["P_k_max_1/Mpc"] = v
        else:
            params[k] = v
    if params.get("N_ncdm") == 0:
        params["N_ur"] = 3.044
        params.pop("m_ncdm", None)

    output = Class()
    output.set(params)
    output.compute(level=level)
    return output


def get_transfer_function(classy_output, kind: str = "d_m", z: float = 0):
    """Transfer function of a field at redshift z from a live CLASS run
    (reference get_transfer_function, classy_interface.py:115-229).

    kind: 'd_b'/'d_cdm'/'d_m' density, 'v_b'/'v_cdm' velocity magnitude,
    'v_cb' relative baryon-CDM velocity.  Returns (k [1/Mpc], T(k))."""
    tk = classy_output.get_transfer(z=z)
    k = np.asarray(tk["k (h/Mpc)"]) * classy_output.h()
    if kind == "v_cb":
        t = np.abs(np.asarray(tk["t_b"]) - np.asarray(tk["t_cdm"])) / k
    elif kind.startswith("v_"):
        t = np.abs(np.asarray(tk["t" + kind[1:]])) / k
    else:
        t = np.asarray(tk[kind])
    return k, t


def _fallback_cosmology(inputs):
    if inputs is None:
        from ..inputs import InputParameters

        inputs = InputParameters(random_seed=0)
    return inputs.cosmology


def compute_rms(
    classy_output=None,
    kind: str = "d_m",
    redshifts=0,
    smoothing_radius: float = 0.0,
    *,
    inputs=None,
):
    """Root-mean-square of a field at given redshifts, optionally smoothed
    with a real-space top-hat of comoving radius `smoothing_radius` [Mpc]
    (reference compute_rms, classy_interface.py:231-293).

    Without a classy output this integrates the package's own linear power:
    `d_m` uses the active transfer function (EH by default, or the table
    registered via `register_class_transfer`); `v_cb` uses the v_cb power
    at kinematic decoupling (`Cosmology.power_vcb`), in km/s.
    """
    redshifts = np.atleast_1d(np.asarray(redshifts, np.float64))

    if classy_output is not None:
        rms = []
        for z in redshifts:
            k, t = get_transfer_function(classy_output, kind=kind, z=float(z))
            A_s = classy_output.get_current_derived_parameters(["A_s"])["A_s"]
            prim = A_s * (k / 0.05) ** (classy_output.n_s() - 1.0)
            kr = k * smoothing_radius
            with np.errstate(divide="ignore", invalid="ignore"):
                W = 3.0 * (np.sin(kr) - kr * np.cos(kr)) / kr**3
            W = np.where(kr < 1e-3, 1.0 - 3.0 * kr**2 / 10.0, W)
            var = np.trapezoid(prim * (t * W) ** 2, np.log(k))
            rms.append(np.sqrt(var))
        return np.asarray(rms)

    cosmo = _fallback_cosmology(inputs)
    lnk = np.linspace(np.log(1e-5), np.log(1e3), 4096)
    k = np.exp(lnk)
    kr = k * smoothing_radius
    with np.errstate(divide="ignore", invalid="ignore"):
        W = 3.0 * (np.sin(kr) - kr * np.cos(kr)) / kr**3
    W = np.where(kr < 1e-3, 1.0 - 3.0 * kr**2 / 10.0, W)

    if kind == "v_cb":
        # z-independent: defined at kinematic decoupling (km/s)
        d2 = k**3 * cosmo.power_vcb(k) / (2.0 * np.pi**2)
        rms = np.sqrt(np.trapezoid(d2 * W**2, lnk))
        return np.full(redshifts.shape, rms)

    d2 = k**3 * cosmo.power_in_k(k) / (2.0 * np.pi**2)
    var0 = np.trapezoid(d2 * W**2, lnk)
    growth = np.asarray([cosmo.dicke(float(z)) for z in redshifts])
    return np.sqrt(var0) * growth


def find_redshift_kinematic_decoupling(classy_output=None, *, inputs=None) -> float:
    """Redshift of kinematic decoupling, defined as x_e = n_e/(n_H+n_He) = 0.1
    (reference find_redshift_kinematic_decoupling, classy_interface.py:295-324;
    z_dec ~ 1060 for Planck18).

    Without classy, inverts the on-the-fly Peebles recombination solve for
    the given cosmology (the bundled RECFAST table starts at z=500, below
    recombination)."""
    if classy_output is not None:
        YHe = classy_output.get_current_derived_parameters(["YHe"])["YHe"]
        z = np.linspace(800, 1200, 400)
        x_e = (
            np.array([classy_output.ionization_fraction(zz) for zz in z])
            * (1.0 - YHe)
            / (1.0 - (1.0 - 1.0 / _not4_) * YHe)
        )
        return float(np.interp(0.1, x_e, z))

    from .recombination import RecombinationHistory

    cosmo = _fallback_cosmology(inputs)
    hist = RecombinationHistory(cosmo, source="PEEBLES")
    z, x_e = hist.z_grid, hist.x_e_grid
    # the solver tracks n_e/n_H; convert to n_e/(n_H + n_He) as above
    YHe = cosmo.Y_He
    x_e = x_e * (1.0 - YHe) / (1.0 - (1.0 - 1.0 / _not4_) * YHe)
    sel = (z > 500) & (z < 1500)
    zs, xs = z[sel], x_e[sel]
    order = np.argsort(xs)
    return float(np.interp(0.1, xs[order], zs[order]))
