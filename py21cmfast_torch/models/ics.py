"""Initial conditions: Gaussian random field + Zel'dovich + 2LPT displacements.

Equivalent of reference InitialConditions.c:547-772, following
py21cmfast_tpu/models/ics.py (its single-device path):

 * The GRF is sampled as *real-space white noise* (a seeded `torch.Generator`)
   and colored in k-space (d_k = rfftn(white) * sqrt(N P(k) / V)).
 * sqrt(P(k)) comes from a 1D log-k table (host float64, quadrature-normalized)
   interpolated on the device.
 * All FFT normalizations use the numpy convention (irfftn includes 1/N):
       delta(x)  = irfftn(d_k)
       psi_i(x)  = irfftn(d_k * i k_i / k^2)                      [ZA, Mpc]
       phi_ij(x) = irfftn(-d_k k_i k_j / k^2)
       psi2_i(x) = irfftn(rfftn(sum_{i<j} phi_ii phi_jj - phi_ij^2) * i k_i/k^2)

The JAX package stages large boxes to fit a 16 GB TPU; on the card the full
grids fit, and the plain path computes the same fields.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..cosmology.constants import physconst
from ..inputs import InputParameters
from ..ops import fft, filters, grids
from ..outputs import InitialConditions

__all__ = ["compute_initial_conditions", "compute_vcb_box", "power_amplitude_table"]


def power_amplitude_table(inputs: InputParameters, device, n: int = 2048):
    """ln(k) -> sqrt(P(k)) table covering the box's k range (built in float64
    on the host, returned as float32 tensors on `device`)."""
    so = inputs.simulation_options
    cosmo = inputs.cosmology
    k_min = 2 * np.pi / (so.box_len * max(so.NON_CUBIC_FACTOR, 1.0)) / 2
    k_max = 2 * np.pi / so.box_len * so.dim * np.sqrt(3.0)  # > corner of hires box
    ln_k = np.linspace(np.log(k_min), np.log(k_max), n)
    p = cosmo.power_in_k(np.exp(ln_k))
    return (
        torch.as_tensor(ln_k, dtype=torch.float32, device=device),
        torch.as_tensor(np.sqrt(p), dtype=torch.float32, device=device),
    )


def _sample_dk(generator, ln_k_table, sqrtp_table, *, hi_shape, box_lens):
    """White noise -> colored k-space field d_k (rfftn layout)."""
    device = ln_k_table.device
    n_tot = hi_shape[0] * hi_shape[1] * hi_shape[2]
    volume = box_lens[0] * box_lens[1] * box_lens[2]
    white = torch.randn(hi_shape, generator=generator, dtype=torch.float32, device=device)
    w_k = fft.rfft3(white)
    del white
    kmag = grids.kmag_grid(hi_shape, box_lens, device)
    lnk = torch.log(torch.where(kmag > 0, kmag, 1.0))
    x0 = ln_k_table[0]
    inv_dx = (ln_k_table.shape[0] - 1) / (ln_k_table[-1] - ln_k_table[0])
    amp = torch.where(kmag > 0, grids.uniform_lerp(lnk, x0, inv_dx, sqrtp_table), 0.0)
    return w_k * (amp * float(np.float32(np.sqrt(n_tot / volume))))


def _filtered_sample(d_k, *, hi_shape, box_lens, out_shape, do_filter):
    """Tophat-filter at the lowres cell scale, c2r, subsample."""
    if do_filter:
        kmag = grids.kmag_grid(hi_shape, box_lens, d_k.device)
        smooth_R = physconst.l_factor * box_lens[0] / out_shape[0]
        d_k = filters.filter_kbox(d_k, kmag, filters.TOPHAT, smooth_R)
    x = fft.irfft3(d_k, hi_shape)
    if out_shape != hi_shape:
        x = grids.subsample(x, out_shape)
    return x


def _kvec(axis, hi_shape, box_lens, device):
    """k_axis broadcast against the rfftn half-space."""
    k = grids.k_axes(hi_shape, box_lens, device)[axis]
    return k.reshape([-1 if a == axis else 1 for a in range(3)])


def _gradient_field(d_k, *, hi_shape, box_lens, axis, out_shape, do_filter):
    """psi_axis = irfftn(d_k i k/k^2), optionally filtered+subsampled."""
    ksq = grids.ksq_grid(hi_shape, box_lens, d_k.device)
    kvec = _kvec(axis, hi_shape, box_lens, d_k.device)
    ksq_safe = torch.where(ksq > 0, ksq, 1.0)
    g_k = (d_k * (1j * kvec / ksq_safe)).masked_fill_(ksq == 0, 0)
    if do_filter:
        kmag = torch.sqrt(ksq)
        smooth_R = physconst.l_factor * box_lens[0] / out_shape[0]
        g_k = filters.filter_kbox(g_k, kmag, filters.TOPHAT, smooth_R)
    x = fft.irfft3(g_k, hi_shape)
    if out_shape != hi_shape:
        x = grids.subsample(x, out_shape)
    return x


def _phi_ij(d_k, *, hi_shape, box_lens, ax_i, ax_j):
    """phi_ij = irfftn(-d_k k_i k_j / k^2) (2LPT potential second derivative)."""
    ksq = grids.ksq_grid(hi_shape, box_lens, d_k.device)
    kv_i = _kvec(ax_i, hi_shape, box_lens, d_k.device)
    kv_j = _kvec(ax_j, hi_shape, box_lens, d_k.device)
    ksq_safe = torch.where(ksq > 0, ksq, 1.0)
    g_k = (-d_k * (kv_i * kv_j / ksq_safe)).masked_fill_(ksq == 0, 0)
    return fft.irfft3(g_k, hi_shape)


# Above this many hires cells the JAX package computes the 2LPT *source* on a
# spectrally truncated copy of d_k (its 16 GB TPU cannot hold the staging).
# The port keeps the same threshold so that both packages give the same
# fields for every box size.
_2LPT_MAX_INHBM_CELLS = 640**3
_2LPT_TRUNC_DIM = 512


def _truncate_dk(d_k, *, hi_shape, trunc_shape):
    """Spectral truncation: keep |k_i| < k_nyquist(trunc) modes of the rfftn
    cube (the four kx/ky corners and the low-kz face), rescaled by
    n_total/N_total to preserve real-space amplitude under numpy's 1/N irfftn
    normalization."""
    hx, hy = trunc_shape[0] // 2, trunc_shape[1] // 2
    hz = trunc_shape[2] // 2
    sx = (slice(0, hx), slice(hi_shape[0] - hx, hi_shape[0]))
    sy = (slice(0, hy), slice(hi_shape[1] - hy, hi_shape[1]))
    out = torch.cat(
        [torch.cat([d_k[s0, s1, : hz + 1] for s1 in sy], dim=1) for s0 in sx], dim=0
    )
    scale = np.prod(trunc_shape) / np.prod(hi_shape)
    return out * float(np.float32(scale))


def _compute_2lpt(d_k, hi_shape, box_lens, pt_shape, do_filter_vel):
    """Scoccimarro 1998 App. D: lap(phi2) = sum_{i<j} phi_ii phi_jj - phi_ij^2."""
    phi = {
        a: _phi_ij(d_k, hi_shape=hi_shape, box_lens=box_lens, ax_i=a, ax_j=a)
        for a in range(3)
    }
    s2 = phi[0] * phi[1] + phi[0] * phi[2] + phi[1] * phi[2]
    del phi
    for ax_i, ax_j in ((0, 1), (0, 2), (1, 2)):
        phi_od = _phi_ij(d_k, hi_shape=hi_shape, box_lens=box_lens, ax_i=ax_i, ax_j=ax_j)
        s2 = s2 - phi_od * phi_od
        del phi_od
    s2_k = fft.rfft3(s2)
    del s2
    return [
        _gradient_field(
            s2_k, hi_shape=hi_shape, box_lens=box_lens, axis=ax,
            out_shape=pt_shape, do_filter=do_filter_vel,
        )
        for ax in range(3)
    ]


def vcb_ratio_table(inputs: InputParameters, device, n: int = 2048):
    """ln(k) -> sqrt(P_vcb(k)/P_m(k)) [km/s] for the relative-velocity
    realization (reference compute_relative_velocities, InitialConditions.c:141),
    built in float64 on the host and returned as float32 tensors on `device`."""
    so = inputs.simulation_options
    cosmo = inputs.cosmology
    k_min = 2 * np.pi / (so.box_len * max(so.NON_CUBIC_FACTOR, 1.0)) / 2
    k_max = 2 * np.pi / so.box_len * so.dim * np.sqrt(3.0)
    ln_k = np.linspace(np.log(k_min), np.log(k_max), n)
    k = np.exp(ln_k)
    ratio = np.sqrt(cosmo.power_vcb(k) / cosmo.power_in_k(k))
    return (
        torch.as_tensor(ln_k, dtype=torch.float32, device=device),
        torch.as_tensor(ratio, dtype=torch.float32, device=device),
    )


def compute_vcb_box(inputs: InputParameters, d_k) -> torch.Tensor:
    """Lowres |v_cb| box in km/s at kinematic decoupling, correlated with the
    density realization as the reference does: each component is
    irfftn(d_k i k_i/k sqrt(P_vcb/P)), filtered to the lowres cell and
    subsampled (InitialConditions.c:177-233), then the speed of each cell."""
    so = inputs.simulation_options
    hi_shape, lo_shape, box_lens = so.hires_shape, so.lowres_shape, so.box_lens
    ln_k, ratio = vcb_ratio_table(inputs, d_k.device)
    kmag = grids.kmag_grid(hi_shape, box_lens, d_k.device)
    lnk = torch.log(torch.where(kmag > 0, kmag, 1.0))
    inv_dx = (ln_k.shape[0] - 1) / (ln_k[-1] - ln_k[0])
    amp = torch.where(kmag > 0, grids.uniform_lerp(lnk, ln_k[0], inv_dx, ratio), 0.0)
    kmag_safe = torch.where(kmag > 0, kmag, 1.0)
    del lnk
    speed_sq = None
    for axis in range(3):
        kvec = _kvec(axis, hi_shape, box_lens, d_k.device)
        g_k = d_k * (1j * kvec / kmag_safe) * amp
        if so.dim != so.HII_DIM:
            smooth_R = physconst.l_factor * box_lens[0] / lo_shape[0]
            g_k = filters.filter_kbox(g_k, kmag, filters.TOPHAT, smooth_R)
        v = fft.irfft3(g_k, hi_shape)
        del g_k
        if lo_shape != hi_shape:
            v = grids.subsample(v, lo_shape)
        speed_sq = v * v if speed_sq is None else speed_sq + v * v
    return torch.sqrt(speed_sq)


def compute_initial_conditions(
    inputs: InputParameters,
    *,
    initial_density: np.ndarray | None = None,
    device="cuda",
) -> InitialConditions:
    """Generate ICs.  `initial_density` optionally injects a user hires field
    in place of GRF sampling (reference single_field.py:94-113); otherwise the
    white noise comes from a `torch.Generator` seeded with `random_seed`."""
    dev = resolve_device(device)
    so = inputs.simulation_options
    mo = inputs.matter_options
    hi_shape = so.hires_shape
    lo_shape = so.lowres_shape
    # the displacement fields live on the grid the perturb deposits onto
    pt_shape = hi_shape if mo.PERTURB_ON_HIGH_RES else lo_shape
    box_lens = so.box_lens
    filter_lowres = so.dim != so.HII_DIM
    do_filter_vel = filter_lowres and pt_shape != hi_shape

    if initial_density is not None:
        hires_density = torch.as_tensor(
            np.asarray(initial_density), dtype=torch.float32, device=dev
        ).contiguous()
        if tuple(hires_density.shape) != hi_shape:
            raise ValueError(
                f"initial_density has shape {tuple(hires_density.shape)}, expected {hi_shape}"
            )
        d_k = fft.rfft3(hires_density)
    else:
        ln_k, sqrtp = power_amplitude_table(inputs, dev)
        gen = torch.Generator(device=dev).manual_seed(int(inputs.random_seed))
        d_k = _sample_dk(gen, ln_k, sqrtp, hi_shape=hi_shape, box_lens=box_lens)
        hires_density = fft.irfft3(d_k, hi_shape)

    lowres_density = _filtered_sample(
        d_k, hi_shape=hi_shape, box_lens=box_lens, out_shape=lo_shape,
        do_filter=filter_lowres,
    )
    vel = [
        _gradient_field(
            d_k, hi_shape=hi_shape, box_lens=box_lens, axis=ax,
            out_shape=pt_shape, do_filter=do_filter_vel,
        )
        for ax in range(3)
    ]

    vel_2lpt = (None, None, None)
    if mo.PERTURB_ALGORITHM == "2LPT":
        trunc_shape = tuple(int(round(s * _2LPT_TRUNC_DIM / hi_shape[0])) for s in hi_shape)
        use_trunc = (
            int(np.prod(hi_shape)) >= _2LPT_MAX_INHBM_CELLS
            and all(p <= c for p, c in zip(pt_shape, trunc_shape))
            and all(c % p == 0 for p, c in zip(pt_shape, trunc_shape))
        )
        if use_trunc:
            vel_2lpt = _compute_2lpt(
                _truncate_dk(d_k, hi_shape=hi_shape, trunc_shape=trunc_shape),
                trunc_shape, box_lens, pt_shape, do_filter_vel,
            )
        else:
            vel_2lpt = _compute_2lpt(d_k, hi_shape, box_lens, pt_shape, do_filter_vel)

    lowres_vcb = compute_vcb_box(inputs, d_k) if mo.V_CB_MODEL == "FLUCTS" else None

    return InitialConditions(
        hires_density=hires_density,
        lowres_density=lowres_density,
        vx=vel[0],
        vy=vel[1],
        vz=vel[2],
        vx_2LPT=vel_2lpt[0],
        vy_2LPT=vel_2lpt[1],
        vz_2LPT=vel_2lpt[2],
        lowres_vcb=lowres_vcb,
    )
