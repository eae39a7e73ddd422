"""Global (0-D) evolution driver: the sky-averaged 21-cm signal.

Equivalent of reference drivers/global_evolution.py:26-411, following
py21cmfast_tpu/drivers/global_evolution.py: runs the spin
temperature chain on a single mean-density "cell" (delta = 0) and replaces the
excursion-set ionization with the global volume filling factor, exactly as the
reference's `global_reion_properties` defines it (SpinTemperatureBox.c:931-991):

    Q_HI = 1 - (zeta_a Nion_a + zeta_m Nion_m) / (1 - x_e_ave)

with the MCG term gated on USE_MINI_HALOS and evaluated at the LW-feedback
threshold from the current J_21_LW (thermochem.c lyman_werner_threshold), and
Gamma12 estimated from dQ/dz (global_evolution.py:81-90).  Histories are
returned as a `quantities` dict matching the reference GlobalEvolution class
(and its HDF5 on-disk format).  The Ts and brightness steps run on
`device` on a 1-cell box; the filling factor and Gamma12 are host float64.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..inputs import InputParameters
from ..models import hmf
from ..models.brightness import brightness_temperature
from ..models.ionization import _get_sigma_table
from ..models.spintemp import compute_spin_temperature
from ..outputs import IonizedBox, PerturbedField

__all__ = ["GlobalEvolution", "run_global_evolution"]


@dataclasses.dataclass
class GlobalEvolution:
    """Global histories over node redshifts (reference GlobalEvolution:131).

    `quantities` maps field name -> array over node_redshifts (descending z),
    matching the reference's dict layout and HDF5 format."""

    inputs: InputParameters
    quantities: dict

    @property
    def node_redshifts(self):
        return np.asarray(self.inputs.node_redshifts)

    # legacy attribute accessors (round-2 API)
    @property
    def redshifts(self):
        return self.node_redshifts

    @property
    def neutral_fraction(self):
        return self.quantities["neutral_fraction"]

    @property
    def brightness_temp(self):
        return self.quantities["brightness_temp"]

    @property
    def spin_temperature(self):
        return self.quantities.get("spin_temperature")

    @property
    def kinetic_temperature(self):
        return self.quantities.get("kinetic_temp_neutral")

    @property
    def xray_ionised_fraction(self):
        return self.quantities.get("xray_ionised_fraction")

    @property
    def ionisation_rate_G12(self):
        return self.quantities["ionisation_rate_G12"]

    def save(self, path, clobber: bool = False):
        """Write the reference's on-disk layout (a `global_evolution` marker
        attr + a `quantities` group + the serialized InputParameters)."""
        import json

        import h5py

        from .. import __version__
        from ..input_serialization import serialize_inputs

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(path, "w" if clobber else "a") as fl:
            fl.attrs["global_evolution"] = True
            fl.attrs["__version__"] = __version__
            grp = fl.create_group("quantities")
            for k, v in self.quantities.items():
                grp[k] = np.asarray(v)
            fl.attrs["InputParameters"] = json.dumps(serialize_inputs(self.inputs))

    @classmethod
    def from_file(cls, path):
        import json

        import h5py

        from ..input_serialization import deserialize_inputs

        with h5py.File(path, "r") as fl:
            if not fl.attrs.get("global_evolution", False):
                raise ValueError(f"{path} is not a global_evolution file")
            quantities = {k: fl["quantities"][k][...] for k in fl["quantities"]}
            inputs = (
                deserialize_inputs(json.loads(fl.attrs["InputParameters"]))
                if "InputParameters" in fl.attrs
                else None
            )
        return cls(inputs=inputs, quantities=quantities)


_GLOBAL_SOURCE_MODELS = ("CONST-ION-EFF", "E-INTEGRAL", "L-INTEGRAL")


def _mean(box):
    """numpy's float32 mean of a box, as the JAX package takes it."""
    return float(np.mean(box.cpu().numpy()))


def run_global_evolution(
    inputs: InputParameters,
    source_model: str | None = None,
    min_redshift: float | None = None,
    max_redshift: float | None = None,
    *,
    device="cuda",
) -> GlobalEvolution:
    """Compute global histories (reference run_global_evolution:253); the
    1-cell boxes live on `device`."""
    dev = resolve_device(device)
    if source_model is None:
        if inputs.matter_options.source_model_uses_halo_sampler:
            raise ValueError(
                "You did not specify 'source_model', but SOURCE_MODEL in "
                "`inputs` has discrete halos! Either specify 'source_model' or "
                "change SOURCE_MODEL to a model with no discrete halos."
            )
        source_model = inputs.matter_options.SOURCE_MODEL
    if source_model not in _GLOBAL_SOURCE_MODELS:
        raise ValueError(
            f"'source_model' must be one of {_GLOBAL_SOURCE_MODELS}, "
            f"got {source_model}"
        )

    if not inputs.node_redshifts:
        inputs = inputs.with_logspaced_redshifts(
            min_redshift if min_redshift is not None else 5.5,
            max_redshift or inputs.simulation_options.Z_HEAT_MAX,
        )
    # single-cell 0-D mode (reference overrides HII_DIM=DIM=1, BOX_LEN=1e6,
    # PERTURB_ALGORITHM=LINEAR; run_global_evolution:332-346)
    inputs1 = inputs.evolve_input_structs(
        HII_DIM=1, DIM=2, BOX_LEN=1.5, SOURCE_MODEL=source_model,
        PERTURB_ALGORITHM="LINEAR",
    )
    so = inputs1.simulation_options
    shape = so.lowres_shape
    cosmo = inputs.cosmology
    ao = inputs.astro_options
    ap = inputs.astro_params
    sigma_table = _get_sigma_table(inputs)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    ln_mmax = np.log(hmf.M_MAX_INTEGRAL)

    # global v_cb entering the LW threshold (reference drivers/
    # global_evolution.py:92-99): mean speed for FLUCTS/AVG-AUTO, the debug
    # constant for AVG-DEBUG, 0 when relative velocities are off
    if inputs.matter_options.V_CB_MODEL in ("FLUCTS", "AVG-AUTO"):
        v_cb_avg = float(cosmo.V_CB_AVG)
    elif inputs.matter_options.V_CB_MODEL == "AVG-DEBUG":
        v_cb_avg = float(ap.V_CB_AVG_DEBUG)
    else:
        v_cb_avg = 0.0

    node_z = np.asarray(inputs.node_redshifts)
    quantities: dict[str, list] = {
        "neutral_fraction": [],
        "brightness_temp": [],
        "tau_21": [],
        "ionisation_rate_G12": [],
    }
    if ao.USE_TS_FLUCT:
        for k in ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction"):
            quantities[k] = []
    if ao.USE_MINI_HALOS:
        quantities["J_21_LW"] = []

    ts_state, prev_z, prev_q = None, None, None
    for z in node_z:
        pf = PerturbedField(
            redshift=np.float32(z),
            density=torch.zeros(shape, dtype=torch.float32, device=dev),
            velocity_z=torch.zeros(shape, dtype=torch.float32, device=dev),
        )
        ts = None
        x_e_ave, jlw_ave = 0.0, 0.0
        if ao.USE_TS_FLUCT:
            ts, ts_state = compute_spin_temperature(
                float(z), inputs1, pf, prev_state=ts_state, prev_redshift=prev_z, device=dev
            )
            x_e_ave = _mean(ts.xray_ionised_fraction)
            if ts.J_21_LW is not None:
                jlw_ave = _mean(ts.J_21_LW)

        # global filling factor (global_reion_properties,
        # SpinTemperatureBox.c:974-991)
        sc = hmf.set_scaling_constants(float(z), inputs)
        m_min = hmf.minimum_source_mass(float(z), inputs)
        if inputs.matter_options.source_model_is_mass_dependent:
            nion_a = float(
                hmf.nion_general(
                    sigma_table, cosmo, hmf_int, float(z), np.log(m_min), ln_mmax,
                    sc.mturn_a_nofb, sc,
                )
            )
            zeta_a = sc.pop2_ion * sc.fstar_10 * sc.fesc_10
            nion_m, zeta_m = 0.0, 0.0
            if ao.USE_MINI_HALOS:
                mcrit_lw = float(
                    hmf.lyman_werner_threshold(float(z), jlw_ave, v_cb_avg, ap,
                                               v_cb_avg=cosmo.V_CB_AVG)
                )
                nion_m = float(
                    hmf.nion_general_mini(
                        sigma_table, cosmo, hmf_int, float(z), np.log(m_min),
                        ln_mmax, max(mcrit_lw, sc.mturn_m_nofb), sc,
                    )
                )
                zeta_m = sc.pop3_ion * sc.fstar_7 * sc.fesc_7
            nion_sum = zeta_a * nion_a + zeta_m * nion_m
        else:
            nion_sum = inputs.astro_params.HII_EFF_FACTOR * float(
                hmf.fcoll_general(
                    sigma_table, cosmo, hmf_int, float(z), np.log(m_min), ln_mmax
                )
            )
        q_hi = max(1.0 - nion_sum / max(1.0 - x_e_ave, 1e-10), 0.0)

        # crude global Gamma12 from dQ/dz (reference global_evolution.py:81-90)
        if prev_q is not None and prev_z is not None and z != prev_z:
            dqdz = (q_hi - prev_q) / (z - prev_z)
            dzdt = -(1.0 + z) * float(cosmo.hubble(float(z)))
            g12 = abs(dqdz * dzdt)
        else:
            g12 = 0.0

        def full(v):
            return torch.full(shape, float(np.float32(v)), dtype=torch.float32, device=dev)

        ion = IonizedBox(
            redshift=np.float32(z),
            neutral_fraction=full(q_hi),
            z_reion=full(-1.0 if q_hi > 0 else z),
            ionisation_rate_G12=full(g12),
            mean_f_coll=np.float32(nion_sum),
            mean_f_coll_MINI=np.float32(0.0),
            log10_Mturnover_ave=np.float32(np.log10(max(sc.mturn_a_nofb, 1.0))),
            log10_Mturnover_MINI_ave=np.float32(
                np.log10(max(sc.mturn_m_nofb, 1.0))
            ),
        )
        tb = brightness_temperature(inputs1, ion, pf, spin_temp=ts, device=dev)

        quantities["neutral_fraction"].append(q_hi)
        quantities["brightness_temp"].append(_mean(tb.brightness_temp))
        quantities["tau_21"].append(_mean(tb.tau_21) if tb.tau_21 is not None else 0.0)
        quantities["ionisation_rate_G12"].append(g12)
        if ts is not None:
            quantities["spin_temperature"].append(_mean(ts.spin_temperature))
            quantities["kinetic_temp_neutral"].append(_mean(ts.kinetic_temp_neutral))
            quantities["xray_ionised_fraction"].append(x_e_ave)
        if ao.USE_MINI_HALOS:
            quantities["J_21_LW"].append(jlw_ave)
        prev_z, prev_q = float(z), q_hi

    return GlobalEvolution(
        inputs=inputs,
        quantities={k: np.asarray(v) for k, v in quantities.items()},
    )
