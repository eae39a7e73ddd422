"""XraySourceBox: pre-filtered SFR / X-ray shells for the spin temperature.

Equivalent of reference UpdateXraySourceBox + one_annular_filter
(SpinTemperatureBox.c:647-804) and the Python-side shell loop
(single_field.py:473-640), following py21cmfast_tpu/models/xray_source.py:
for each of the N_STEP_TS concentric shells, the halo SFR/X-ray grids are
interpolated to the shell's emission redshift z''(R) from the two bracketing
node HaloBoxes, annulus-filtered (filter type 4; the Lya multiple-scattering
window, type 5, for the SFR shells when LYA_MULTIPLE_SCATTERING,
SpinTemperatureBox.c:753), clamped at 0 and written into the shell stacks.
The shells are a Python loop; each reads its two node grids in place, so the
node history is never stacked.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..cosmology.constants import H0_PER_h, physconst
from ..inputs import InputParameters
from ..ops import filters
from ..ops.gridops import SINGLE, for_mesh
from ..outputs import XraySourceBox
from .spintemp import setup_z_edges

__all__ = ["compute_xray_source_field", "lya_diffusion_scale"]

N_MS_K = 2048  # k points of the host-tabulated multiple-scattering windows

_f32 = np.float32


def lya_diffusion_scale(redshift: float, inputs: InputParameters, x_HI: float) -> float:
    """Comoving Lya diffusion scale R_star in Mpc (arXiv:2601.14360 Eq. 24;
    reference single_field.py:558-574).  Proportional to the global neutral
    fraction — 0 after reionization (the MS window then degenerates to the
    straight-line annulus, filtering.c:166-172)."""
    cp = inputs.cosmo_params
    cosmo = inputs.cosmology
    A_alpha = 6.25e8  # Hz, Lya Einstein-A
    nu_lya = 2.46606727e15  # Hz
    n_H_z0 = (1.0 - cosmo.Y_He) * cosmo.rho_crit_cgs * cp.OMb / physconst.m_p  # cm^-3
    H0 = cp.hlittle * H0_PER_h  # s^-1
    r_cm = (
        3.0 * physconst.c_cms**4 * A_alpha**2 * n_H_z0 * x_HI * (1.0 + redshift)
    ) / (32.0 * np.pi**3 * nu_lya**4 * H0**2 * cp.OMm)
    return r_cm / physconst.cm_per_Mpc


def _exact_shell_redshifts(redshift: float, r_outer: np.ndarray,
                           inputs: InputParameters) -> np.ndarray:
    """Mean emission redshift of each shell from the exact comoving-distance
    inversion (reference single_field.py:499-516: `z_at_value` on the shell's
    comoving edges, then zpp_avg = edge - d(edge)/2)."""
    cosmo = inputs.cosmology
    z_hi = max(2.0 * float(inputs.simulation_options.Z_HEAT_MAX), redshift + 10.0)
    zg = np.linspace(redshift, z_hi, 8192)
    drdz = np.abs(
        (1.0 + zg) * physconst.c_cms * cosmo.dtdz(zg)
    ) / physconst.cm_per_Mpc
    dist = np.concatenate(
        [[0.0], np.cumsum(0.5 * (drdz[1:] + drdz[:-1]) * np.diff(zg))]
    )
    edges = np.interp(np.asarray(r_outer, np.float64), dist, zg)
    prev = np.concatenate([[redshift], edges[:-1]])
    return edges - 0.5 * (edges - prev)


def _annulus_scan(sfr_nodes, xray_nodes, sfr_mini_nodes, idx_lo, idx_hi, weights, r_inner,
                  r_outer, do_filter, live, ms_k_table, ms_w_tables, *, shape, box_lens,
                  use_lw=False, gops=SINGLE):
    """The shell stacks.  `*_nodes` are lists of the node grids (ascending
    redshift; `sfr_mini_nodes` None without minihalos, `ms_w_tables` None
    without multiple scattering); per shell `idx_lo`/`idx_hi`/`weights`
    interpolate between two nodes, `r_inner`/`r_outer` are the annulus,
    `do_filter` is False for the unfiltered first shell and `live` is False
    for shells beyond the oldest node or Z_HEAT_MAX, which stay 0.  Returns
    the stacks (sfr, xray, sfr_mini, sfr_lw, sfr_mini_lw), None where unused.
    `gops` takes the FFTs and |k| (ops/gridops.py; on a mesh the grids are
    x-slabs and `shape` the global shape)."""
    dev = sfr_nodes[0].device
    n_r = len(r_outer)
    kmag = gops.kmag(shape, box_lens, dev)
    ms_grid = filters.ms_interp_grid(kmag, ms_k_table) if ms_w_tables is not None else None

    def stack(on):
        return (torch.zeros((n_r,) + gops.local_shape(shape), dtype=torch.float32, device=dev)
                if on else None)

    use_mini = sfr_mini_nodes is not None
    out = dict(sfr=stack(True), xray=stack(True), sfr_mini=stack(use_mini),
               sfr_lw=stack(use_lw), sfr_mini_lw=stack(use_lw))
    # the SFR grids see the Lya window and, when `use_lw`, the plain annulus
    # again for the LW photons (straight lines), from one forward transform
    fields = [("sfr", sfr_nodes, True), ("xray", xray_nodes, False)]
    if use_mini:
        fields.append(("sfr_mini", sfr_mini_nodes, True))
    for i in range(n_r):
        if not live[i]:
            continue
        i0, i1 = int(idx_lo[i]), int(idx_hi[i])
        w = _f32(weights[i])
        one_m_w, w = float(_f32(1.0) - w), float(w)
        shell_w = lya_w = None
        if do_filter[i]:
            shell_w = lya_w = filters.w_shell(kmag, r_inner[i], r_outer[i])
            if ms_grid is not None:
                lya_w = filters.w_multiple_scattering(ms_grid, ms_w_tables[i])
        for name, nodes, lya in fields:
            grid = nodes[i0] * one_m_w + nodes[i1] * w
            lw = lya and use_lw
            if shell_w is None:
                out[name][i] = torch.clamp_min(grid, 0.0)
                if lw:
                    out[name + "_lw"][i] = out[name][i]
                continue
            g_k = gops.rfft3(grid)
            window = lya_w if lya else shell_w
            out[name][i] = torch.clamp_min(gops.irfft3(g_k * window, shape), 0.0)
            if lw:
                out[name + "_lw"][i] = torch.clamp_min(gops.irfft3(g_k * shell_w, shape), 0.0)
    return out


def compute_xray_source_field(
    redshift: float,
    inputs: InputParameters,
    halobox_nodes: list,
    previous_ionized_box=None,
    mesh=None,
    *,
    device="cuda",
) -> XraySourceBox:
    """Build the filtered source shells.

    halobox_nodes: list of (z_node, HaloBox) with z_node >= redshift (earlier
    snapshots), in any order; shells interpolate between the bracketing nodes
    (reference interp_halo_boxes, single_field.py:382).  Only `halo_sfr`,
    `halo_xray`, `halo_sfr_mini` and `log10_Mcrit_MCG_ave` of each HaloBox
    are read, so a history of HaloBoxes trimmed to those gives the same
    result.  previous_ionized_box sets the global x_HI entering the Lya
    diffusion scale when LYA_MULTIPLE_SCATTERING (reference
    single_field.py:549-574).  With `mesh` (a parallel.mesh.Mesh) the grids
    are this rank's x-slabs, the shells are filtered by the slab FFT and
    x_HI is the mean over the ranks."""
    dev = resolve_device(device)
    gops = for_mesh(mesh)
    so = inputs.simulation_options
    ao = inputs.astro_options
    shape = so.lowres_shape
    ladder = setup_z_edges(redshift, inputs)
    n_r = len(ladder.R)

    # Shell emission redshifts for the halobox interpolation: the reference
    # inverts the EXACT comoving distance for the shell edges
    # (single_field.py:499-516, z_at_value) rather than reusing the Ts
    # ladder's chained first-order z edges (setup_z_edges).
    zpp_interp = _exact_shell_redshifts(redshift, ladder.R, inputs)

    nodes = sorted(halobox_nodes, key=lambda t: t[0])
    z_nodes = np.array([t[0] for t in nodes])
    # shells whose emission redshift lies above Z_HEAT_MAX (or above the
    # oldest computed HaloBox) carry no sources: the reference zeroes them
    # rather than clamping to the oldest node (single_field.py:585-597)
    z_shell_max = min(float(z_nodes[-1]), float(so.Z_HEAT_MAX))
    live_shell = zpp_interp < z_shell_max
    use_mini = bool(ao.USE_MINI_HALOS) and all(t[1].halo_sfr_mini is not None for t in nodes)

    idx_lo = np.searchsorted(z_nodes, zpp_interp) - 1
    idx_lo = np.clip(idx_lo, 0, len(z_nodes) - 1)
    idx_hi = np.clip(idx_lo + 1, 0, len(z_nodes) - 1)
    denom = np.where(idx_hi > idx_lo, z_nodes[idx_hi] - z_nodes[idx_lo], 1.0)
    w = np.clip((zpp_interp - z_nodes[idx_lo]) / denom, 0.0, 1.0)

    use_ms = bool(ao.LYA_MULTIPLE_SCATTERING)
    ms_k_table = ms_w_tables = None
    if use_ms:
        if previous_ionized_box is not None:
            if previous_ionized_box.neutral_fraction is None:
                raise ValueError(
                    "previous_ionized_box.neutral_fraction is None — the "
                    "coeval chain slimming (drivers/coeval._slim_chain_ion) "
                    "only keeps it when the sources come from grids"
                )
            x_HI = float(gops.mean(previous_ionized_box.neutral_fraction.double(), shape))
        else:
            x_HI = 1.0
        r_star = lya_diffusion_scale(redshift, inputs, x_HI)
        k_max = float(np.sqrt(3.0) * np.pi * max(s / l for s, l in zip(shape, so.box_lens)))
        ms_w_tables = np.ones((n_r, N_MS_K), np.float32)
        for i in range(n_r):
            if ladder.R_inner[i] > 0:
                _, ms_w_tables[i] = filters.ms_filter_table(
                    k_max, float(ladder.R_inner[i]), float(ladder.R[i]), r_star, N_MS_K)
        ms_k_table = np.linspace(0.0, k_max, N_MS_K, dtype=np.float32)

    def grids_of(name):
        return [getattr(t[1], name).to(dev) for t in nodes]

    scan_args = (
        grids_of("halo_sfr"), grids_of("halo_xray"),
        grids_of("halo_sfr_mini") if use_mini else None,
        idx_lo, idx_hi, w, ladder.R_inner, ladder.R, ladder.R_inner > 0, live_shell,
        ms_k_table, ms_w_tables,
    )
    scan_kwargs = dict(shape=shape, box_lens=so.box_lens, use_lw=use_ms and use_mini)
    if mesh is not None:
        from ..parallel.shardcall import sharded_kernel_call

        shells = sharded_kernel_call(mesh, _annulus_scan, scan_args, scan_kwargs, shape)
    else:
        shells = _annulus_scan(*scan_args, **scan_kwargs)
    del scan_args
    mean_mcrit = None
    if use_mini:
        # per-shell mean log10 MCG turnover, z-interpolated between nodes
        # (reference single_field.py:580-640, mean_log10_Mcrit_LW); dead
        # shells get the M_TURN floor (single_field.py:592)
        mcrit_nodes = np.array([float(t[1].log10_Mcrit_MCG_ave) for t in nodes])
        mean_mcrit = torch.as_tensor(
            np.where(
                live_shell,
                mcrit_nodes[idx_lo] * (1.0 - w) + mcrit_nodes[idx_hi] * w,
                float(inputs.astro_params.M_TURN),
            ).astype(np.float32),
            device=dev,
        )
    return XraySourceBox(
        redshift=np.float32(redshift),
        filtered_sfr=shells["sfr"],
        filtered_sfr_mini=shells["sfr_mini"],
        filtered_xray=shells["xray"],
        mean_log10_Mcrit_LW=mean_mcrit,
        filtered_sfr_lw=shells["sfr_lw"],
        filtered_sfr_mini_lw=shells["sfr_mini_lw"],
    )
