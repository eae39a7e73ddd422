"""Coeval cubes: the snapshot pipeline, evolved down the node ladder.

Equivalent of reference drivers/coeval.py:521-992 (`generate_coeval` /
`run_coeval`), following py21cmfast_tpu/drivers/coeval.py: the ICs are
computed once, then the union of the node redshifts and the
requested ones is visited highest first.  Each node runs perturb ->
[HaloBox] -> Ts -> prefetch of the next node's tables -> ionize -> Tb; the
ionized box and the spin-temperature state are handed to the next node, and
only the requested redshifts are yielded.  With a Lagrangian source model
each node's HaloBox feeds ionization and, trimmed to the grids the shells
read, a history from which the XraySourceBox of the Ts step is built: the
fixed grids of SOURCE_MODEL 'L-INTEGRAL', or with a halo sampler
('CHMF-SAMPLER', 'DEXM-ESF') the node's halo catalog, perturbed and
gridded.  The catalogs are sampled before the scroll, ascending in z
(reference evolve_halos, coeval.py:435), and wait on the host until their
node.  Under a PHOTON_CONS_TYPE the photon-conservation calibration runs
first, and every ionization step reads its state.

With an `OutputCache` every computed box is written, in full, once the
node's fields are checked, and a later run with the same inputs resumes:
the leading nodes whose chain-coupling boxes are all cached (`RunCache`)
are read back onto the run's device instead of computed, yielded where
requested, and handed down the chain exactly as computed ones are.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .._device import resolve_device
from ..exceptions import begin_validate_snapshot, check_nonfinite
from ..inputs import InputParameters
from ..io import h5 as h5io
from ..io.caching import CacheConfig, OutputCache, RunCache
from ..models import ics as ics_module
from ..models import halobox as halobox_module
from ..models import halos as halos_module
from ..models import ionization, perturb, spintemp, xray_source
from ..models.brightness import brightness_temperature
from ..models.hmf import set_scaling_constants
from ..models.photoncons import setup_photon_cons
from ..outputs import (
    BrightnessTemp,
    HaloBox,
    InitialConditions,
    IonizedBox,
    PerturbedField,
    TsBox,
)

__all__ = ["Coeval", "run_coeval", "generate_coeval"]


@dataclasses.dataclass
class Coeval:
    """All output boxes at one redshift (reference coeval.py:61)."""

    redshift: float
    initial_conditions: InitialConditions
    perturbed_field: PerturbedField
    ionized_box: IonizedBox
    brightness_temperature: BrightnessTemp
    spin_temp: TsBox | None = None
    halobox: HaloBox | None = None

    @property
    def brightness_temp(self):
        return self.brightness_temperature.brightness_temp

    @property
    def neutral_fraction(self):
        return self.ionized_box.neutral_fraction

    @property
    def density(self):
        return self.perturbed_field.density


def _slim_chain_ion(ion: IonizedBox | None, keep_xh: bool):
    """Drop the IonizedBox fields nothing downstream in the scroll reads: the
    next snapshot only needs z_reion, ionisation_rate_G12, the mean f_coll
    scalars, cumulative_recombinations and the unnormalised_nion stacks, and
    the neutral fraction when the sources come from grids (its mean sets the
    Lya diffusion scale of the XraySourceBox)."""
    if ion is None:
        return ion
    return dataclasses.replace(
        ion, neutral_fraction=ion.neutral_fraction if keep_xh else None,
        mean_free_path=None, kinetic_temperature=None,
    )


def _slim_history_box(hb: HaloBox) -> HaloBox:
    """The part of a node's HaloBox that later XraySourceBoxes read: the SFR
    and X-ray grids (and the MCG SFR) and the mean MCG turnover."""
    return dataclasses.replace(
        hb, n_ion=None, whalo_sfr=None, halo_stars=None, halo_stars_mini=None
    )


def _slim_chain_pf(pf: PerturbedField | None, needed: bool):
    """The previous PerturbedField is read only by the minihalo Nion
    trapezoid (ionization's tracked Nion history), and then only its density."""
    if pf is None or not needed:
        return None
    return dataclasses.replace(pf, velocity_z=None, velocity_x=None, velocity_y=None)


def _required_redshifts(inputs: InputParameters, out_redshifts):
    """Union of node redshifts and requested outputs, descending
    (reference _get_required_redshifts_coeval, coeval.py:971)."""
    zs = set(float(z) for z in out_redshifts)
    zs |= set(float(z) for z in inputs.node_redshifts)
    return sorted(zs, reverse=True)


def generate_coeval(
    inputs: InputParameters,
    out_redshifts=(),
    initial_conditions: InitialConditions | None = None,
    cache: OutputCache | None = None,
    cache_config: CacheConfig | None = None,
    regenerate: bool = False,
    *,
    device="cuda",
):
    """Yield a Coeval at each requested redshift, highest first, evolving
    down the node-redshift ladder (reference _redshift_loop_generator,
    coeval.py:749).  Every snapshot's fields are checked for NaN/Inf one
    node late, as in the JAX package: a non-finite node is raised on after
    its Coeval was yielded, at the next node or after the last one.

    With an `OutputCache` as `cache`, the boxes that `cache_config` names
    (all by default) are written, and the scroll resumes after the last
    fully cached node (reference coeval.py:700-747); `regenerate=True`
    recomputes everything while still writing."""
    dev = resolve_device(device)
    if cache is not None:
        if not isinstance(cache, OutputCache):
            raise TypeError(f"cache must be an OutputCache, not {type(cache).__name__}")
        h5io.require_h5py()
        cache_config = cache_config or CacheConfig()
    ao = inputs.astro_options
    mo = inputs.matter_options
    out_redshifts = [float(z) for z in np.atleast_1d(np.asarray(out_redshifts))]
    all_z = _required_redshifts(inputs, out_redshifts)
    if not all_z:
        raise ValueError("no redshifts requested")

    needs_evolution = ao.USE_TS_FLUCT or ao.uses_recombination or inputs.node_redshifts

    def cache_write(box, z=None):
        if cache is not None and box is not None and cache_config.writes(type(box).__name__):
            cache.write(box, inputs, z)

    if initial_conditions is None:
        if cache is not None and not regenerate:
            initial_conditions = cache.read(InitialConditions, inputs, device=dev)
        if initial_conditions is None:
            initial_conditions = ics_module.compute_initial_conditions(inputs, device=dev)
            cache_write(initial_conditions)

    # resume: the leading nodes (highest z first) whose chain-coupling boxes
    # are all cached
    resumed = set()
    if cache is not None and not regenerate and needs_evolution:
        rc = RunCache(cache, inputs)
        for z in all_z:
            if not rc.is_complete_at(z):
                break
            resumed.add(z)

    # photon non-conservation (reference _setup_ics_and_pfs_for_scrolling):
    # the calibration runs once per inputs and device, before the halo chain
    photoncons_state = setup_photon_cons(inputs, device=dev)

    lagrangian = mo.source_model_uses_lagrangian_grids
    sampler = mo.source_model_uses_halo_sampler
    # the halo chain, ascending in z: DexM and the grid sampler at the lowest
    # node, then the progenitors of each catalog at the next node up; the
    # catalogs of the nodes to come wait on the host.  Resumed nodes are the
    # high-z end of the chain and need no catalog.
    catalogs = {}
    if sampler:
        cat = None
        for z in sorted(all_z):
            if z in resumed:
                break
            cat = halos_module.determine_halo_catalog(
                z, inputs, initial_conditions, previous_catalog=cat, device=dev)
            catalogs[z] = cat.to("cpu")
        del cat

    prev_ion: IonizedBox | None = None
    prev_pf: PerturbedField | None = None
    prev_z = None
    ts_state = None  # the previous TsBox (its J_21_LW sets the LW feedback)
    halobox_nodes = []  # (z, trimmed HaloBox) history for the XraySourceBox shells
    pending_validation = None
    for i, z in enumerate(all_z):
        wanted = (not out_redshifts) or any(abs(z - oz) < 1e-8 for oz in out_redshifts)
        if z in resumed:
            # read the node's boxes back instead of computing them
            pf = cache.read(PerturbedField, inputs, z, device=dev)
            ion = cache.read(IonizedBox, inputs, z, device=dev)
            ts = cache.read(TsBox, inputs, z, device=dev) if ao.USE_TS_FLUCT else None
            halobox = cache.read(HaloBox, inputs, z, device=dev)
            if halobox is not None and ao.USE_TS_FLUCT:
                halobox_nodes.append((z, _slim_history_box(halobox)))
            ts_state = ts if ts is not None else ts_state
            if wanted:
                yield Coeval(
                    redshift=z,
                    initial_conditions=initial_conditions,
                    perturbed_field=pf,
                    ionized_box=ion,
                    brightness_temperature=cache.read(BrightnessTemp, inputs, z, device=dev),
                    spin_temp=ts,
                    halobox=halobox,
                )
            prev_ion = _slim_chain_ion(ion, keep_xh=halobox is not None) if needs_evolution else None
            prev_pf = _slim_chain_pf(pf, needed=ao.USE_MINI_HALOS and not lagrangian)
            prev_z = z
            del ion, pf, ts, halobox
            continue

        pf = perturb.perturb_field(z, inputs, initial_conditions, device=dev)

        halobox = None
        if sampler:
            pt_halos = halos_module.perturb_halo_catalog(
                z, inputs, initial_conditions, catalogs.pop(z).to(dev), device=dev)
            halobox = halobox_module.compute_halo_grid(
                z, inputs, pt_halos, previous_spin_temp=ts_state, previous_ionized_box=prev_ion,
                lagrangian_delta=initial_conditions.lowres_density,
                lowres_vcb=initial_conditions.lowres_vcb, ics=initial_conditions, device=dev,
            )
            del pt_halos
        elif lagrangian:
            mt_a_grid = mt_m_grid = None
            if ao.USE_MINI_HALOS:
                mt_a_grid, mt_m_grid = halobox_module._mcrit_grids(
                    z, inputs, set_scaling_constants(z, inputs), ts_state, prev_ion,
                    initial_conditions.lowres_vcb, device=dev,
                )
            halobox = halobox_module.compute_fixed_halo_grid(
                z, inputs, initial_conditions.lowres_density,
                mt_a_grid=mt_a_grid, mt_m_grid=mt_m_grid, ics=initial_conditions, device=dev,
            )
            del mt_a_grid, mt_m_grid

        ts = None
        if ao.USE_TS_FLUCT:
            source_box = None
            if halobox is not None:
                halobox_nodes.append((z, _slim_history_box(halobox)))
                if ts_state is not None and z < inputs.simulation_options.Z_HEAT_MAX:
                    source_box = xray_source.compute_xray_source_field(
                        z, inputs, halobox_nodes, previous_ionized_box=prev_ion, device=dev
                    )
            ts, ts_state = spintemp.compute_spin_temperature(
                z, inputs, pf, prev_state=ts_state, prev_redshift=prev_z,
                initial_conditions=initial_conditions, source_box=source_box,
                previous_ionized_box=prev_ion, device=dev,
            )
            del source_box
            # overlap the next node's host-side SFRD tables with this node's
            # device work (worker thread; see spintemp.prefetch_sfrd_tables)
            if i + 1 < len(all_z):
                spintemp.prefetch_sfrd_tables(all_z[i + 1], inputs)

        ion = ionization.compute_ionization_field(
            z, inputs, pf, previous_ionized_box=prev_ion, spin_temp=ts,
            prev_redshift=prev_z, previous_perturbed_field=prev_pf,
            vcb_box=initial_conditions.lowres_vcb, halobox=halobox,
            photoncons_state=photoncons_state, device=dev,
        )
        # the previous node's Nion stacks (2 x n_R grids with minihalos) are
        # read: release the scroll's hold on them now
        prev_ion = prev_pf = None
        tb = brightness_temperature(inputs, ion, pf, spin_temp=ts, device=dev)
        # lag-1 validation, as the JAX package's scroll: check the previous
        # node's sweep (its copy is long done), start this node's unwaited
        check_nonfinite(pending_validation)
        pending_validation = begin_validate_snapshot(z, pf, halobox, ts, ion, tb)
        for box in (pf, halobox, ts, ion, tb):
            cache_write(box, z)

        if wanted:
            yield Coeval(
                redshift=z,
                initial_conditions=initial_conditions,
                perturbed_field=pf,
                ionized_box=ion,
                brightness_temperature=tb,
                spin_temp=ts,
                halobox=halobox,
            )

        # keep only what the next snapshot reads; without evolution there is
        # no coupling between snapshots
        prev_ion = _slim_chain_ion(ion, keep_xh=halobox is not None) if needs_evolution else None
        prev_pf = _slim_chain_pf(pf, needed=ao.USE_MINI_HALOS and not lagrangian)
        prev_z = z
        del ion, pf, ts, tb, halobox

    # the last node's sweep has no successor to check it
    check_nonfinite(pending_validation)


def run_coeval(
    inputs: InputParameters,
    out_redshifts,
    initial_conditions: InitialConditions | None = None,
    cache: OutputCache | None = None,
    cache_config: CacheConfig | None = None,
    regenerate: bool = False,
    *,
    device="cuda",
):
    """Compute coeval boxes at the given redshifts (reference run_coeval:690)."""
    single = np.isscalar(out_redshifts)
    coevals = list(
        generate_coeval(
            inputs, np.atleast_1d(out_redshifts), initial_conditions, cache,
            cache_config, regenerate, device=device,
        )
    )
    return coevals[0] if single and len(coevals) == 1 else coevals
