"""21-cm brightness temperature.

Equivalent of reference BrightnessTemperatureBox.c:22-105, following
py21cmfast_tpu/models/brightness.py: one elementwise expression per cell.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..cosmology.constants import physconst
from ..inputs import InputParameters
from ..outputs import BrightnessTemp, IonizedBox, PerturbedField, TsBox

__all__ = ["brightness_temperature", "brightness_constant"]


def brightness_constant(inputs: InputParameters, redshift: float) -> float:
    """The saturated-Ts Tb prefactor in mK (BrightnessTemperatureBox.c:49-53)."""
    cp = inputs.cosmo_params
    return (
        27.0
        * (cp.OMb * cp.hlittle**2 / 0.023)
        * ((0.15 / cp.OMm / cp.hlittle**2) * (1.0 + redshift) / 10.0) ** 0.5
    )


def _tb_kernel(xh, delta, ts, const_factor, t_rad, zp1, *, use_ts):
    """Tb (and tau21 with a spin temperature).  The scalars are float32 0-d
    tensors on the grids' device, `ts` a grid or a scalar."""
    tb = const_factor * xh * (1.0 + delta)
    if use_ts:
        # optical-depth form: tau21 = prefactors * (1+z)/Ts (in K; the 1000
        # converts the mK prefactor), then Tb = (1-exp(-tau)) (Ts-Tcmb)/(1+z)
        tau = tb * zp1 / (1000.0 * ts)
        tb = (1.0 - torch.exp(-tau)) * 1000.0 * (ts - t_rad) / zp1
        return tb, tau
    return tb, None


def brightness_temperature(
    inputs: InputParameters,
    ionized_box: IonizedBox,
    perturbed_field: PerturbedField,
    spin_temp: TsBox | None = None,
    *,
    device="cuda",
) -> BrightnessTemp:
    """Brightness temperature of the ionized box: saturated-Ts without
    `spin_temp`, the optical-depth form with it.  The fields are moved to
    `device` if they live elsewhere."""
    dev = resolve_device(device)
    redshift = float(ionized_box.redshift)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    tb, tau = _tb_kernel(
        ionized_box.neutral_fraction.to(dev),
        perturbed_field.density.to(dev),
        spin_temp.spin_temperature.to(dev) if spin_temp is not None else scalar(1.0),
        scalar(brightness_constant(inputs, redshift)),
        scalar(physconst.T_cmb * (1 + redshift)),
        scalar(1.0 + redshift),
        use_ts=spin_temp is not None,
    )
    return BrightnessTemp(redshift=np.float32(redshift), brightness_temp=tb, tau_21=tau)
