"""Lightcone driver.

Equivalent of py21cmfast_tpu/drivers/lightcone.py (reference
drivers/lightcone.py:49-734): scroll the coeval pipeline down the node
redshifts, interpolate each adjacent pair onto lightcone slices written
straight into the cone on the run's device, record the global quantities
(one stacked tensor of means a node, fetched once at the end), and finally
apply the velocity-gradient correction and RSDs along the line of sight on
the same device.  A checkpoint file (HDF5, the JAX package's layout) lets an
interrupted run restart after its last completed node, and an output cache
handed to the coeval scroll lets it skip the nodes already computed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rsds as rsds_module
from .._device import resolve_device
from ..inputs import InputParameters
from ..lightconers import Lightconer, RectilinearLightconer
from ..outputs import InitialConditions
from .coeval import generate_coeval

__all__ = ["LightCone", "run_lightcone", "generate_lightcone"]


@dataclasses.dataclass
class LightCone:
    """Assembled lightcone(s) + global history (reference lightcone.py:49-372).

    `lightcones` maps a quantity to its (N, N, n_slices) float32 tensor on the
    run's device; `global_quantities` maps a quantity to its float64 means
    over the node redshifts."""

    inputs: InputParameters
    lightconer: Lightconer
    lightcones: dict
    global_quantities: dict
    node_redshifts: np.ndarray
    log10_mturnovers: np.ndarray | None = None

    @property
    def brightness_temp(self):
        return self.lightcones.get("brightness_temp")

    @property
    def lc_distances(self):
        return self.lightconer.lc_distances

    @property
    def lc_redshifts(self):
        return self.lightconer.lc_redshifts(self.inputs.cosmology)

    @property
    def global_xH(self):
        return self.global_quantities.get("neutral_fraction")

    @property
    def shape(self):
        q = next(iter(self.lightcones.values()))
        return tuple(q.shape)

    def to_numpy(self) -> dict:
        """Every lightcone as numpy (copied to the host)."""
        return {q: t.detach().cpu().numpy() for q, t in self.lightcones.items()}


def _checkpoint_save(path, inputs, lightcones, gq, last_node: int):
    """Write the partial lightcone + `_last_completed_node` (reference
    lightcone.py:411-463 `LightCone.make_checkpoint`)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["full_hash"] = inputs.full_hash
        f.attrs["_last_completed_node"] = last_node
        g = f.create_group("lightcones")
        for q, t in lightcones.items():
            g.create_dataset(q, data=t.cpu().numpy())
        g2 = f.create_group("global_quantities")
        for q, vals in gq.items():
            g2.create_dataset(q, data=np.asarray(vals, np.float64))


def _checkpoint_load(path, inputs, lightcones, gq) -> int:
    """Restore a partial lightcone into `lightcones` and `gq`; returns
    `_last_completed_node` (-1 if no usable checkpoint).  A hash mismatch
    (different inputs) is ignored."""
    from pathlib import Path

    if not Path(path).exists():
        return -1
    import h5py

    with h5py.File(path, "r") as f:
        if f.attrs.get("full_hash") != inputs.full_hash:
            return -1
        last = int(f.attrs["_last_completed_node"])
        for q, t in lightcones.items():
            if q in f["lightcones"]:
                t.copy_(torch.from_numpy(f["lightcones"][q][...]))
        for q in gq:
            if q in f["global_quantities"]:
                gq[q] = list(f["global_quantities"][q][...])
    return last


def _global_quantities(gq_host, means, names):
    """float64 means by quantity: those restored from a checkpoint, then the
    per-node device means (one transfer)."""
    new = torch.stack(means).double().cpu().numpy() if means else np.zeros((0, len(names)))
    return {q: np.concatenate([np.asarray(gq_host[q], np.float64), new[:, j]])
            for j, q in enumerate(names)}


def generate_lightcone(
    inputs: InputParameters,
    lightconer: Lightconer | None = None,
    max_redshift: float | None = None,
    min_redshift: float | None = None,
    initial_conditions: InitialConditions | None = None,
    global_quantities=("brightness_temp", "neutral_fraction"),
    include_dvdr_in_tau21: bool = True,
    apply_rsds: bool = True,
    cache=None,
    checkpoint_path=None,
    *,
    device="cuda",
):
    """Yield (z, coeval, partial LightCone) per node; the final yield,
    (None, None, lc), carries the finished cone.

    `cache` (an OutputCache) is forwarded to the coeval scroll, which writes
    every box and resumes from the cached nodes.  `checkpoint_path`
    checkpoints the partial lightcone each node (slices, global quantities,
    `_last_completed_node`) so an interrupted run restarts after the last
    completed node (reference lightcone.py:223-248 and 411-463); h5py is
    imported only for these two."""
    dev = resolve_device(device)
    if not inputs.node_redshifts:
        if min_redshift is None:
            raise ValueError("need node_redshifts or min_redshift")
        inputs = inputs.with_logspaced_redshifts(
            min_redshift, max_redshift or inputs.simulation_options.Z_HEAT_MAX
        )
    node_z = np.asarray(inputs.node_redshifts)  # descending
    use_ts = inputs.astro_options.USE_TS_FLUCT

    if lightconer is None:
        lightconer = RectilinearLightconer.with_equal_cdist_slices(
            min_redshift=float(node_z.min()),
            max_redshift=float(node_z.max()),
            inputs=inputs,
            quantities=("brightness_temp",) + (("tau_21",) if use_ts else ()),
        )
    cosmo = inputs.cosmology

    quantities = list(lightconer.quantities)
    if apply_rsds or include_dvdr_in_tau21:
        quantities.append("velocity_z")
    if include_dvdr_in_tau21 and use_ts:
        # the optically-thin dvdr correction needs tau_21 along the cone
        quantities.append("tau_21")
    quantities = tuple(dict.fromkeys(quantities))

    shape = inputs.simulation_options.lowres_shape[:2] + (lightconer.n_slices,)
    lightcones = {q: torch.zeros(shape, dtype=torch.float32, device=dev) for q in quantities}
    gq_host = {q: [] for q in global_quantities}
    means = []  # one device tensor of the global quantities' means a node
    lc = LightCone(
        inputs=inputs,
        lightconer=lightconer,
        lightcones=lightcones,
        global_quantities={},
        node_redshifts=node_z,
    )
    last_completed = (
        -1 if checkpoint_path is None
        else _checkpoint_load(checkpoint_path, inputs, lightcones, gq_host)
    )

    prev_coeval = None
    for i_node, coeval in enumerate(
        generate_coeval(inputs, out_redshifts=node_z,
                        initial_conditions=initial_conditions, cache=cache, device=dev)
    ):
        if i_node > last_completed:
            if global_quantities:
                means.append(torch.stack(
                    [lightconer.get_field(coeval, q).mean() for q in global_quantities]))
            if prev_coeval is not None:
                for q in quantities:
                    idx, vals = lightconer.make_lightcone_slices(
                        coeval, prev_coeval, cosmo, inputs, q)
                    if idx is not None:
                        lightcones[q][:, :, idx] = vals
            if checkpoint_path is not None:
                _checkpoint_save(checkpoint_path, inputs, lightcones,
                                 _global_quantities(gq_host, means, global_quantities), i_node)
        # the lightconer reads no Nion stacks: keep the previous node without
        # them, so that the next node's scan frees them once it has read them
        prev_coeval = dataclasses.replace(coeval, ionized_box=dataclasses.replace(
            coeval.ionized_box, unnormalised_nion=None, unnormalised_nion_mini=None))
        yield coeval.redshift, coeval, lc
        del coeval

    lc.global_quantities = _global_quantities(gq_host, means, global_quantities)

    # ----- finalization: dvdr correction + RSDs (lightcone.py:249-372) -----
    lc_z = lightconer.lc_redshifts(cosmo)
    if include_dvdr_in_tau21 and "brightness_temp" in lightcones:
        lightcones["brightness_temp"] = rsds_module.include_dvdr_in_tau21(
            lightcones["brightness_temp"],
            lightcones["velocity_z"],
            lc_z,
            inputs,
            periodic=False,
            tau_21=lightcones.get("tau_21") if use_ts else None,
        )
    if apply_rsds and "brightness_temp" in lightcones:
        lightcones["brightness_temp"] = rsds_module.apply_rsds(
            lightcones["brightness_temp"],
            lightcones["velocity_z"],
            lc_z,
            inputs,
            periodic=False,
        )
    yield None, None, lc


def run_lightcone(inputs: InputParameters, **kwargs) -> LightCone:
    """Run the full lightcone pipeline (reference run_lightcone:727-734)."""
    lc = None
    for step in generate_lightcone(inputs, **kwargs):
        lc = step[2]
        del step  # holds the node's coeval while the next one is computed
    return lc
