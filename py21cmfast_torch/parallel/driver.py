"""Slab-sharded coeval and lightcone drivers: ICs -> perturb -> [HaloBox]
-> [Ts] -> ionization (with inhomogeneous recombinations) -> Tb, every rank
on its own x-slab, following py21cmfast_tpu/parallel/driver.py.

SPMD: every rank calls the driver with the same inputs and the same mesh;
each keeps its slab of every grid for the whole scroll, and the ranks meet
only in the slab FFTs, the means over the box, the ghost exchanges of the
deposits and the catalog gathers of the halo sampler.  The stages are the
single-device model functions called with `mesh=`, whose scans take the
mesh's GridOps (ops/gridops.py).  The returned fields are this rank's slabs;
`mesh.gather_slabs` assembles a whole box.

Scope: as the JAX package's sharded driver.  Eulerian sources with
USE_TS_FLUCT, USE_MINI_HALOS (the sharded v_cb realization and the feedback
turnover grids) and RECOMB_MODEL INHOMOGENEOUS; the halo-sampler models
(the slab sampler of parallel/sampler.py, the sharded painting of
parallel/halopaint.py and the XraySourceBox shells through the slab FFT);
Zel'dovich or 2LPT displacements.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..inputs import InputParameters
from .mesh import gather_slabs, make_mesh
from .perturb import build_sharded_lowres_ics, build_sharded_perturb

__all__ = ["run_sharded_coeval", "run_sharded_lightcone", "sharded_white_noise"]

_f32 = np.float32


def sharded_white_noise(inputs: InputParameters, mesh, white=None):
    """This rank's slab of the hires white noise: the global box drawn from a
    `torch.Generator` seeded with random_seed on the rank's device (what the
    single-device ICs draw), or of `white` (a numpy global array)."""
    if white is not None:
        return mesh.local_slab(np.asarray(white, np.float32))
    hi_shape = inputs.simulation_options.hires_shape
    gen = torch.Generator(device=mesh.device).manual_seed(int(inputs.random_seed))
    full = torch.randn(hi_shape, generator=gen, dtype=torch.float32, device=mesh.device)
    slab = mesh.local_slab(full).clone()
    del full
    return slab


def _sharded_ics(inputs, mesh, white):
    """The ICs as an InitialConditions of this rank's slabs."""
    from ..models.ics import power_amplitude_table, vcb_ratio_table
    from ..outputs import InitialConditions

    so = inputs.simulation_options
    mo = inputs.matter_options
    dev = mesh.device
    use_2lpt = mo.PERTURB_ALGORITHM == "2LPT"
    with_vcb = mo.V_CB_MODEL == "FLUCTS"
    ics_fn = build_sharded_lowres_ics(mesh, so.hires_shape, so.lowres_shape, so.box_lens,
                                      use_2lpt=use_2lpt, with_vcb=with_vcb)
    ln_k, sqrtp = power_amplitude_table(inputs, dev)
    vcb_args = vcb_ratio_table(inputs, dev) if with_vcb else ()
    fields = list(ics_fn(sharded_white_noise(inputs, mesh, white), ln_k, sqrtp, *vcb_args))
    lowres_vcb = fields.pop() if with_vcb else None
    hires_density, lowres_density, psi_x, psi_y, psi_z = fields[:5]
    psi2 = fields[5:8] if use_2lpt else (None, None, None)
    return InitialConditions(
        hires_density=hires_density, lowres_density=lowres_density,
        vx=psi_x, vy=psi_y, vz=psi_z,
        vx_2LPT=psi2[0], vy_2LPT=psi2[1], vz_2LPT=psi2[2],
        lowres_vcb=lowres_vcb,
    )


def _margin(inputs, mesh, ics, all_z):
    """Ghost rows of the perturb deposit: the x-displacement bound at the
    largest growth factor among the redshifts, reduced over the ranks."""
    so = inputs.simulation_options
    cosmo = inputs.cosmology
    d_init = float(cosmo.dicke(so.INITIAL_REDSHIFT))
    max_fac = max(float(cosmo.dicke(z)) - d_init for z in all_z)
    local = [float(ics.vx.abs().max()),
             float(ics.vx_2LPT.abs().max()) if ics.vx_2LPT is not None else 0.0]
    # the maxima over every rank: ranks with margins of different sizes
    # would corrupt the exchange
    max_psi, max_psi2 = mesh.all_reduce_floats(local, "max")
    max_disp = max_psi * max_fac
    if ics.vx_2LPT is not None:
        max_fac2 = max(abs((-3.0 / 7.0) * (float(cosmo.dicke(z)) ** 2 - d_init**2)) for z in all_z)
        max_disp += max_psi2 * max_fac2
    margin = int(np.ceil(max_disp * so.lowres_shape[0] / so.box_lens[0])) + 3
    return min(margin, so.lowres_shape[0] // mesh.size)


def _gathered_ics(mesh, ics):
    """The ICs' lowres displacement fields of the whole box (for the halo
    catalog's perturb, which reads them at any halo)."""
    def g(v):
        return None if v is None else gather_slabs(mesh, v)

    return SimpleNamespace(vx=g(ics.vx), vy=g(ics.vy), vz=g(ics.vz), vx_2LPT=g(ics.vx_2LPT),
                           vy_2LPT=g(ics.vy_2LPT), vz_2LPT=g(ics.vz_2LPT))


def run_sharded_coeval(inputs: InputParameters, out_redshifts, mesh=None, *, white=None):
    """Compute snapshots on the mesh (every rank calls it), evolving down the
    redshift ladder.

    Returns a list of namespaces of this rank's slabs.  With USE_TS_FLUCT /
    a recombination model the node ladder in `inputs.node_redshifts` is
    scrolled as the single-device coeval driver does.  `white` (a numpy
    array of the hires shape) replaces the white noise drawn from
    random_seed.  `mesh` defaults to `make_mesh()` (NCCL)."""
    from ..models.brightness import brightness_temperature
    from ..models.ionization import compute_ionization_field
    from ..models.spintemp import compute_spin_temperature
    from ..outputs import PerturbedField

    if mesh is None:
        mesh = make_mesh()
    dev = mesh.device
    so = inputs.simulation_options
    ao = inputs.astro_options
    mo = inputs.matter_options
    cosmo = inputs.cosmology
    use_halos = mo.source_model_uses_halo_sampler
    use_2lpt = mo.PERTURB_ALGORITHM == "2LPT"

    ics = _sharded_ics(inputs, mesh, white)
    out_redshifts = [float(z) for z in np.atleast_1d(np.asarray(out_redshifts))]
    all_z = sorted(set(out_redshifts) | {float(z) for z in inputs.node_redshifts}, reverse=True)

    margin = _margin(inputs, mesh, ics, all_z)
    perturb_fn = build_sharded_perturb(mesh, so.hires_shape, so.lowres_shape, so.box_lens,
                                       margin, use_2lpt=use_2lpt)
    mass_factor = float(np.prod(so.lowres_shape) / np.prod(so.hires_shape))
    d_init = float(cosmo.dicke(so.INITIAL_REDSHIFT))

    # ----- discrete halos: slab-parallel sampling, ascending z, then the
    # sharded painting at each node
    halo_cats = None
    if use_halos:
        from .sampler import determine_halo_catalog_slabs

        halo_cats = {}
        cat = None
        for z in sorted(all_z):
            cat = determine_halo_catalog_slabs(z, inputs, ics, mesh, previous_catalog=cat)
            halo_cats[z] = cat
        ics_whole = _gathered_ics(mesh, ics)

    prev_ion = prev_pf = ts_state = prev_ts = prev_z = None
    halobox_nodes = []  # (z, HaloBox) history for the XraySourceBox shells
    out = []
    for z in all_z:
        D = float(cosmo.dicke(z))
        fac_za = D - d_init
        fac_2lpt = (-3.0 / 7.0) * (D**2 - d_init**2)
        dDdt_over_D = float(cosmo.ddicke_dt(z) / D)
        delta, v_z = perturb_fn(ics.hires_density, ics.vx, ics.vy, ics.vz,
                                ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT,
                                float(_f32(d_init)), fac_za, fac_2lpt, mass_factor, dDdt_over_D)
        pf = PerturbedField(redshift=np.float32(z), density=delta, velocity_z=v_z)

        halobox = None
        if use_halos:
            halobox = _halo_node(z, inputs, mesh, ics, ics_whole, halo_cats[z], prev_ts, prev_ion)

        ts = None
        if ao.USE_TS_FLUCT:
            source_box = None
            if halobox is not None:
                from ..models.xray_source import compute_xray_source_field

                halobox_nodes.append((z, halobox))
                if ts_state is not None and z < so.Z_HEAT_MAX:
                    source_box = compute_xray_source_field(
                        z, inputs, halobox_nodes, previous_ionized_box=prev_ion, mesh=mesh,
                        device=dev)
            ts, ts_state = compute_spin_temperature(
                z, inputs, pf, prev_state=ts_state, prev_redshift=prev_z,
                initial_conditions=ics, source_box=source_box, previous_ionized_box=prev_ion,
                mesh=mesh, device=dev)

        ion = compute_ionization_field(
            z, inputs, pf, previous_ionized_box=prev_ion, spin_temp=ts, halobox=halobox,
            previous_perturbed_field=prev_pf, prev_redshift=prev_z, vcb_box=ics.lowres_vcb,
            mesh=mesh, device=dev)
        tb = brightness_temperature(inputs, ion, pf, spin_temp=ts, device=dev)

        if (not out_redshifts) or any(abs(z - oz) < 1e-8 for oz in out_redshifts):
            out.append(SimpleNamespace(
                redshift=z,
                density=delta,
                velocity_z=v_z,
                neutral_fraction=ion.neutral_fraction,
                brightness_temp=tb.brightness_temp,
                spin_temperature=ts.spin_temperature if ts is not None else None,
                cumulative_recombinations=ion.cumulative_recombinations,
                # Coeval-shaped views for the Lightconer interface
                perturbed_field=pf,
                ionized_box=ion,
                spin_temp=ts,
                brightness_temperature=tb,
                halobox=halobox,
            ))
        prev_ion, prev_pf, prev_ts, prev_z = ion, pf, ts, z
    return out


def _halo_node(z, inputs, mesh, ics, ics_whole, catalog, prev_ts, prev_ion):
    """The node's sharded HaloBox: the catalog perturbed by the whole-box
    displacement fields, painted onto the slabs, plus the expected sources
    below SAMPLER_MIN_MASS (HaloBox.c:626-640)."""
    from ..models.halobox import _mcrit_grids, compute_fixed_halo_grid
    from ..models.halos import perturb_halo_catalog
    from ..models.hmf import set_scaling_constants
    from ..ops.gridops import GridOps
    from .halopaint import sharded_halo_grids

    so = inputs.simulation_options
    ao = inputs.astro_options
    dev = mesh.device
    pt_halos = perturb_halo_catalog(z, inputs, ics_whole, catalog, device=dev)
    halobox = sharded_halo_grids(z, inputs, pt_halos, mesh, previous_spin_temp=prev_ts,
                                 previous_ionized_box=prev_ion, lowres_vcb=ics.lowres_vcb)
    mt_a_grid = mt_m_grid = None
    if ao.USE_MINI_HALOS:
        mt_a_grid, mt_m_grid = _mcrit_grids(
            z, inputs, set_scaling_constants(z, inputs), prev_ts, prev_ion, ics.lowres_vcb,
            dev, GridOps(mesh).local_shape(so.lowres_shape))
    sub = compute_fixed_halo_grid(z, inputs, ics.lowres_density, m_max=so.SAMPLER_MIN_MASS,
                                  mt_a_grid=mt_a_grid, mt_m_grid=mt_m_grid, ics=ics, mesh=mesh,
                                  device=dev)
    if sub is not None:
        halobox.n_ion = halobox.n_ion + sub.n_ion
        halobox.halo_sfr = halobox.halo_sfr + sub.halo_sfr
        halobox.whalo_sfr = halobox.whalo_sfr + sub.whalo_sfr
        halobox.halo_xray = halobox.halo_xray + sub.halo_xray
        if ao.USE_MINI_HALOS and sub.halo_sfr_mini is not None:
            halobox.halo_sfr_mini = halobox.halo_sfr_mini + sub.halo_sfr_mini
            halobox.halo_stars_mini = halobox.halo_stars_mini + sub.halo_stars_mini
    return halobox


def run_sharded_lightcone(
    inputs: InputParameters,
    mesh=None,
    lightconer=None,
    min_redshift: float | None = None,
    max_redshift: float | None = None,
    global_quantities=("brightness_temp", "neutral_fraction"),
    include_dvdr_in_tau21: bool = True,
    apply_rsds: bool = True,
    *,
    white=None,
):
    """The lightcone on the mesh: the node scroll of run_sharded_coeval,
    each rank interpolating its own x-rows of every slice, the global means
    reduced over the ranks; the finished cones are gathered along x on every
    rank, where the dvdr and RSD finalization of the single-device driver
    applies.  Returns a LightCone of whole cones on the mesh's device."""
    from .. import rsds as rsds_module
    from ..drivers.lightcone import LightCone
    from ..lightconers import RectilinearLightconer
    from ..ops.gridops import GridOps

    if mesh is None:
        mesh = make_mesh()
    dev = mesh.device
    gops = GridOps(mesh)
    if not inputs.node_redshifts:
        if min_redshift is None:
            raise ValueError("need node_redshifts or min_redshift")
        inputs = inputs.with_logspaced_redshifts(
            min_redshift, max_redshift or inputs.simulation_options.Z_HEAT_MAX)
    node_z = np.asarray(inputs.node_redshifts)  # descending
    cosmo = inputs.cosmology
    use_ts = inputs.astro_options.USE_TS_FLUCT
    shape = inputs.simulation_options.lowres_shape

    if lightconer is None:
        lightconer = RectilinearLightconer.with_equal_cdist_slices(
            min_redshift=float(node_z.min()),
            max_redshift=float(node_z.max()),
            inputs=inputs,
            quantities=("brightness_temp",) + (("tau_21",) if use_ts else ()),
        )
    quantities = list(lightconer.quantities)
    if apply_rsds or include_dvdr_in_tau21:
        quantities.append("velocity_z")
    if include_dvdr_in_tau21 and use_ts:
        quantities.append("tau_21")
    quantities = tuple(dict.fromkeys(quantities))

    local = gops.local_shape(shape)[:2] + (lightconer.n_slices,)
    cones = {q: torch.zeros(local, dtype=torch.float32, device=dev) for q in quantities}
    means = []
    prev = None
    for coeval in run_sharded_coeval(inputs, list(node_z), mesh=mesh, white=white):
        if global_quantities:
            means.append(gops.means(
                [lightconer.get_field(coeval, q) for q in global_quantities], shape))
        if prev is not None:
            for q in quantities:
                idx, vals = lightconer.make_lightcone_slices(coeval, prev, cosmo, inputs, q)
                if idx is not None:
                    cones[q][:, :, idx] = vals
        prev = coeval
    lightcones = {q: gather_slabs(mesh, c) for q, c in cones.items()}
    del cones
    gq = np.asarray(means, np.float64).reshape(len(means), len(global_quantities))

    lc_z = lightconer.lc_redshifts(cosmo)
    if include_dvdr_in_tau21 and "brightness_temp" in lightcones:
        lightcones["brightness_temp"] = rsds_module.include_dvdr_in_tau21(
            lightcones["brightness_temp"], lightcones["velocity_z"], lc_z, inputs,
            periodic=False, tau_21=lightcones.get("tau_21") if use_ts else None)
    if apply_rsds and "brightness_temp" in lightcones:
        lightcones["brightness_temp"] = rsds_module.apply_rsds(
            lightcones["brightness_temp"], lightcones["velocity_z"], lc_z, inputs, periodic=False)
    return LightCone(
        inputs=inputs,
        lightconer=lightconer,
        lightcones=lightcones,
        global_quantities={q: gq[:, j] for j, q in enumerate(global_quantities)},
        node_redshifts=node_z,
    )
