"""Runs the port's multi-rank code on gloo ranks on the CPU, for the
`tests/test_torch_parallel*.py` files.

`start_ranks(world, jobs, tmp_path)` spawns `world` processes (the "spawn"
start method), forms one gloo process group through a FileStore under
`tmp_path` (so that parallel test workers never share a port), caps each
rank at one intra-op thread and one BLAS thread (several ranks' BLAS pools
would otherwise spin against each other on the shared cores), runs the jobs in order on every rank with a
CPU mesh; `collect` joins every rank under its own timeout, after which a
rank still running is terminated and the jobs fail.  A job is (name, args):
a function of this module, called as fn(mesh, *args); the value of rank 0
comes back (each job gathers what it returns), or a JobError with the
traceback of the first rank whose job raised.

Each rank would otherwise spend ~8 s of one core on the Gauss-Legendre
nodes of the cosmology's sigma normalization (numpy's `leggauss`); the
parent computes them once and hands them over, bit for bit the same.

This module imports no JAX: the spawned ranks import it, and the port must
run without JAX.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
import traceback

import numpy as np

JOIN_TIMEOUT = 120.0  # seconds for each rank, from the start of the run
_ONE_THREAD = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}


class JobError(AssertionError):
    pass


_nodes = {}


def _gauss_legendre_nodes():
    """{degree: leggauss(degree)} of the cosmology's quadrature."""
    if not _nodes:
        from py21cmfast_torch.cosmology import power

        _nodes[power._GL_NODES] = np.polynomial.legendre.leggauss(power._GL_NODES)
    return dict(_nodes)


def _use_nodes(nodes):
    leggauss = np.polynomial.legendre.leggauss

    def cached(deg):
        return nodes[deg] if deg in nodes else leggauss(deg)

    np.polynomial.legendre.leggauss = cached


def _rank_main(rank, world, store_path, out_dir, jobs, nodes):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    _use_nodes(nodes)
    results = []
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world)
        from py21cmfast_torch.parallel.mesh import make_mesh

        mesh = make_mesh(world, device="cpu")
        for name, args in jobs:
            try:
                out = globals()[name](mesh, *args)
                results.append(("ok", out if rank == 0 else None))
            except Exception:
                results.append(("error", traceback.format_exc()))
                break
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
        if dist.is_initialized():
            dist.destroy_process_group()


def start_ranks(world, jobs, tmp_path):
    """Start the ranks of a run; `collect` waits for them.  Several runs
    may be under way at once."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path)
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    nodes = _gauss_legendre_nodes()
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, out_dir, jobs, nodes))
             for r in range(world)]
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    os.environ.update(_ONE_THREAD)  # read by the children's BLAS at their start
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(world=world, jobs=jobs, out_dir=out_dir, procs=procs, t0=time.monotonic())


def collect(run, timeout=JOIN_TIMEOUT):
    """Rank 0's value of each job of a started run, in job order; a job
    that failed, on any rank, gives its JobError in its place (and so do the
    jobs after it).  Ranks still running `timeout` seconds after their start
    are terminated, and every job gives a JobError."""
    world, jobs, out_dir, procs = run["world"], run["jobs"], run["out_dir"], run["procs"]
    late = []
    for r, p in enumerate(procs):
        p.join(max(0.0, timeout - (time.monotonic() - run["t0"])))
        if p.is_alive():
            late.append(r)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    if late:
        err = JobError(f"ranks {late} of {world} did not finish within {timeout:.0f} s")
        return [err] * len(jobs)
    per_rank = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            err = JobError(f"rank {r} of {world} exited with {procs[r].exitcode} and no result")
            return [err] * len(jobs)
        with open(path, "rb") as fh:
            per_rank.append(pickle.load(fh))
    out = []
    for j, (name, _) in enumerate(jobs):
        err = None
        for r, res in enumerate(per_rank):
            if j >= len(res):
                err = JobError(f"job {name} did not run on rank {r} (an earlier job failed)")
            elif res[j][0] == "error":
                err = JobError(f"job {name} failed on rank {r} of {world}:\n{res[j][1]}")
            if err is not None:
                break
        out.append(err if err is not None else per_rank[0][j][1])
    return out


def result(value):
    """A job's value, raising its JobError."""
    if isinstance(value, JobError):
        raise value
    return value


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A gloo mesh of this process alone (a FileStore under `tmp_path`),
    the process group destroyed on exit."""
    import torch.distributed as dist

    from py21cmfast_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(str(tmp_path), "store1"), 1),
                            rank=0, world_size=1)
    try:
        yield make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# jobs: fn(mesh, *args); numpy in, numpy out (gathered over the ranks)


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _gather(mesh, t):
    from py21cmfast_torch.parallel.mesh import gather_slabs

    return None if t is None else _np(gather_slabs(mesh, t))


def _ky_gather(mesh, k):
    """A ky-sharded (nx, ny/p, nzh) half-box, whole."""
    return _np(mesh.all_gather_rows(k.transpose(0, 1).contiguous()).transpose(0, 1))


def pfft_job(mesh, x, box_lens):
    """rfft3 of the slabs of `x`, its inverse, and the local |k|, whole."""
    from py21cmfast_torch.parallel import pfft

    slab = mesh.local_slab(x)
    k = pfft.rfft3(mesh, slab)
    back = pfft.irfft3(mesh, k, x.shape[2])
    kmag = pfft.local_kmag(mesh, x.shape, box_lens, slab.device)
    return dict(k=_ky_gather(mesh, k), back=_gather(mesh, back), kmag=_ky_gather(mesh, kmag))


def collectives_job(mesh):
    """all_to_all along (0, 1) and (1, 0) and the ghost exchange, on
    rank-stamped arrays, every rank's results gathered."""
    import torch

    p, r = mesh.size, mesh.rank
    x = torch.arange(4 * p * 3 * p * 2, dtype=torch.float32).reshape(4 * p, 3 * p, 2) + 1000 * r
    a = mesh.all_to_all(x, split_axis=1, concat_axis=0)
    b = mesh.all_to_all(x, split_axis=0, concat_axis=1)
    c = mesh.all_to_all(torch.complex(x, -x), split_axis=1, concat_axis=0)
    left = torch.full((2, 3), 10.0 * r + 1)
    right = torch.full((2, 3), 10.0 * r + 2)
    from_right, from_left = mesh.exchange(left, right)
    rows = mesh.all_gather_rows(torch.arange(r + 1, dtype=torch.float32)[:, None] + 100 * r)
    return dict(a=_np(mesh.all_gather(a[None])), b=_np(mesh.all_gather(b[None])),
                c=_np(mesh.all_gather(c[None])),
                from_right=_np(mesh.all_gather(from_right[None])),
                from_left=_np(mesh.all_gather(from_left[None])), rows=_np(rows),
                sum=float(mesh.all_reduce(torch.tensor(float(r + 1)))),
                max=mesh.all_reduce_floats([float(r), -float(r)], "max"))


def ics_perturb_job(mesh, inputs, white, redshift):
    """build_sharded_lowres_ics from `white` and build_sharded_perturb at
    `redshift` with the driver's margin, whole boxes."""
    from py21cmfast_torch.parallel import driver

    so = inputs.simulation_options
    cosmo = inputs.cosmology
    ics = driver._sharded_ics(inputs, mesh, white)
    margin = driver._margin(inputs, mesh, ics, [redshift])
    fn = driver.build_sharded_perturb(mesh, so.hires_shape, so.lowres_shape, so.box_lens, margin,
                                      use_2lpt=ics.vx_2LPT is not None)
    d_init = float(cosmo.dicke(so.INITIAL_REDSHIFT))
    D = float(cosmo.dicke(redshift))
    delta, v_z = fn(ics.hires_density, ics.vx, ics.vy, ics.vz, ics.vx_2LPT, ics.vy_2LPT,
                    ics.vz_2LPT, float(np.float32(d_init)), D - d_init,
                    (-3.0 / 7.0) * (D**2 - d_init**2),
                    float(np.prod(so.lowres_shape) / np.prod(so.hires_shape)),
                    float(cosmo.ddicke_dt(redshift) / D))
    out = {k: _gather(mesh, getattr(ics, k)) for k in (
        "hires_density", "lowres_density", "vx", "vy", "vz", "vx_2LPT", "vy_2LPT", "vz_2LPT",
        "lowres_vcb")}
    out.update(density=_gather(mesh, delta), velocity_z=_gather(mesh, v_z), margin=margin)
    return out


def _catalog(cat):
    import torch

    from py21cmfast_torch.outputs import PerturbedHaloCatalog

    return PerturbedHaloCatalog(
        redshift=np.float32(cat["redshift"]),
        **{k: torch.as_tensor(np.asarray(cat[k])) for k in (
            "halo_masses", "halo_coords", "star_rng", "sfr_rng", "xray_rng")},
        n_halos=int(len(cat["halo_masses"])))


def halopaint_job(mesh, inputs, redshift, cat, prev):
    """sharded_halo_grids of one perturbed catalog (numpy dict) with the
    previous boxes' fields `prev` (whole numpy grids or None), whole grids
    and the turnover means."""
    from types import SimpleNamespace

    from py21cmfast_torch.parallel.halopaint import sharded_halo_grids

    def slabs(d):
        if d is None:
            return None
        return SimpleNamespace(**{k: mesh.local_slab(v) for k, v in d.items()})

    vcb = mesh.local_slab(prev["vcb"]) if prev and prev.get("vcb") is not None else None
    hb = sharded_halo_grids(redshift, inputs, _catalog(cat), mesh,
                            previous_spin_temp=slabs(prev and prev.get("ts")),
                            previous_ionized_box=slabs(prev and prev.get("ion")), lowres_vcb=vcb)
    out = {k: _gather(mesh, getattr(hb, k)) for k in (
        "n_ion", "halo_sfr", "whalo_sfr", "halo_xray", "halo_sfr_mini", "halo_stars_mini")}
    out.update(l10_a=float(hb.log10_Mcrit_ACG_ave), l10_m=float(hb.log10_Mcrit_MCG_ave))
    return out


def partition_job(mesh, inputs, cat):
    """sample_progenitors_slabs with the progenitor step replaced by the
    identity: the partition and the gathered order of a catalog."""
    from py21cmfast_torch.models import halos
    from py21cmfast_torch.outputs import HaloCatalog
    from py21cmfast_torch.parallel.sampler import sample_progenitors_slabs

    import torch

    def identity(redshift, inputs_, sub, generator, dev):
        return sub

    step = halos._sample_progenitors
    halos._sample_progenitors = identity
    try:
        prev = HaloCatalog(redshift=np.float32(cat["redshift"]), n_halos=len(cat["halo_masses"]),
                           **{k: torch.as_tensor(np.asarray(cat[k])) for k in (
                               "halo_masses", "halo_coords", "star_rng", "sfr_rng", "xray_rng")})
        out = sample_progenitors_slabs(float(cat["redshift"]) + 0.5, inputs, prev, mesh)
    finally:
        halos._sample_progenitors = step
    return {k: _np(getattr(out, k)) for k in ("halo_masses", "halo_coords", "star_rng")}


def stage_reductions(inputs, s, redshift, prev_redshift, mesh=None):
    """The stage functions whose box means are reductions over the ranks,
    on the fields `s` (whole grids, or this rank's slabs with `mesh`):
    compute_ionization_field (the minihalo turnover means; the homogeneous
    recombinations' mean xH and Gamma12), compute_spin_temperature (<x_e>,
    the mean turnover), compute_xray_source_field (x_HI of the Lya
    multiple scattering) and compute_fixed_halo_grid (the mean fix, the
    turnover means, the displacement across slab borders).  `inputs` maps
    the four configurations.  Returns their grids (x first) and scalars."""
    from types import SimpleNamespace

    from py21cmfast_torch.models.halobox import compute_fixed_halo_grid
    from py21cmfast_torch.models.ionization import compute_ionization_field
    from py21cmfast_torch.models.spintemp import compute_spin_temperature
    from py21cmfast_torch.models.xray_source import compute_xray_source_field
    from py21cmfast_torch.outputs import IonizedBox, PerturbedField, TsBox

    pf = PerturbedField(redshift=np.float32(redshift), density=s["density"],
                        velocity_z=s["velocity_z"])
    prev_pf = PerturbedField(redshift=np.float32(prev_redshift), density=s["prev_density"],
                             velocity_z=s["velocity_z"])
    prev_ts = TsBox(redshift=np.float32(prev_redshift), spin_temperature=s["ts"],
                    xray_ionised_fraction=s["xe"], kinetic_temp_neutral=s["tk"],
                    J_21_LW=s["j21"], J_Lya=s["ts"])
    prev_ion = IonizedBox(redshift=np.float32(prev_redshift), neutral_fraction=s["xh"],
                          z_reion=s["zre"], ionisation_rate_G12=s["g12"],
                          mean_f_coll=np.float32(0.0), mean_f_coll_MINI=np.float32(0.0),
                          log10_Mturnover_ave=np.float32(0.0),
                          log10_Mturnover_MINI_ave=np.float32(0.0),
                          cumulative_recombinations=s["rec"])
    ics = SimpleNamespace(lowres_vcb=s["vcb"], vx=s["vx"], vy=s["vy"], vz=s["vz"],
                          vx_2LPT=None, vy_2LPT=None, vz_2LPT=None)
    mini = inputs["mini"]
    ion = compute_ionization_field(redshift, mini, pf, previous_ionized_box=prev_ion,
                                   prev_redshift=prev_redshift, previous_perturbed_field=prev_pf,
                                   vcb_box=s["vcb"], mesh=mesh, device="cpu")
    homog = compute_ionization_field(redshift, inputs["homog"], pf, previous_ionized_box=prev_ion,
                                     prev_redshift=prev_redshift, mesh=mesh, device="cpu")
    ts, _ = compute_spin_temperature(redshift, mini, pf, prev_state=prev_ts,
                                     prev_redshift=prev_redshift, initial_conditions=ics,
                                     previous_ionized_box=prev_ion, mesh=mesh, device="cpu")
    hb = SimpleNamespace(halo_sfr=s["sfr"], halo_xray=s["xray"], halo_sfr_mini=None,
                         log10_Mcrit_MCG_ave=np.float32(8.0))
    xs = compute_xray_source_field(redshift, inputs["lagr_ms"], [(redshift, hb),
                                                                 (redshift + 4.0, hb)],
                                   previous_ionized_box=prev_ion, mesh=mesh, device="cpu")
    fixed = compute_fixed_halo_grid(redshift, inputs["fixed"], s["lowres_density"],
                                    mt_a_grid=s["mt_a"], mt_m_grid=s["mt_m"], ics=ics, mesh=mesh,
                                    device="cpu")
    return dict(
        ion_xh=ion.neutral_fraction,
        ion_l10=(float(ion.log10_Mturnover_ave), float(ion.log10_Mturnover_MINI_ave)),
        homog_rec=homog.cumulative_recombinations,
        ts=ts.spin_temperature, xe=ts.xray_ionised_fraction,
        xs_sfr=xs.filtered_sfr.transpose(0, 1).contiguous(),
        fixed_nion=fixed.n_ion, fixed_sfr=fixed.halo_sfr,
        fixed_l10=(float(fixed.log10_Mcrit_ACG_ave), float(fixed.log10_Mcrit_MCG_ave)),
    )


def reductions_job(mesh, inputs, fields, redshift, prev_redshift):
    """stage_reductions on this rank's slabs of whole numpy `fields`; the
    grids gathered."""
    import torch

    out = stage_reductions(inputs, {k: mesh.local_slab(v) for k, v in fields.items()}, redshift,
                           prev_redshift, mesh)
    return {k: _gather(mesh, v) if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def _coeval_fields(mesh, o):
    return dict(
        redshift=o.redshift,
        density=_gather(mesh, o.density),
        velocity_z=_gather(mesh, o.velocity_z),
        neutral_fraction=_gather(mesh, o.neutral_fraction),
        brightness_temp=_gather(mesh, o.brightness_temp),
        spin_temperature=_gather(mesh, o.spin_temperature),
        cumulative_recombinations=_gather(mesh, o.cumulative_recombinations),
    )


def coeval_job(mesh, inputs, out_redshifts, white):
    """run_sharded_coeval from `white`: every node's fields, whole."""
    from py21cmfast_torch.parallel.driver import run_sharded_coeval

    return [_coeval_fields(mesh, o)
            for o in run_sharded_coeval(inputs, out_redshifts, mesh=mesh, white=white)]


def lightcone_job(mesh, inputs, white):
    """run_sharded_lightcone from `white`: the cones and global quantities."""
    from py21cmfast_torch.parallel.driver import run_sharded_lightcone

    lc = run_sharded_lightcone(inputs, mesh=mesh, white=white)
    return dict(lightcones={q: _np(v) for q, v in lc.lightcones.items()},
                global_quantities=lc.global_quantities)


def halo_coeval_job(mesh, inputs, out_redshifts):
    """run_sharded_coeval of a halo-sampler model: the last node's fields
    and its HaloBox, whole."""
    from py21cmfast_torch.parallel.driver import run_sharded_coeval

    out = run_sharded_coeval(inputs, out_redshifts, mesh=mesh)[-1]
    res = _coeval_fields(mesh, out)
    res["n_ion"] = _gather(mesh, out.halobox.n_ion)
    return res
