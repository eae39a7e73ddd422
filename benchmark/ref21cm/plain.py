"""The reference's own fields, written for the benchmark from the equations: the initial conditions, the 2LPT perturbed density and velocity,
the 21-cm brightness temperature, the lightcone slices between nodes, the
velocity-gradient correction and the redshift-space distortions.

Nothing here comes from the program: each stage is the plain formula on
whole tensors (`torch.fft`, `index_add_`, elementwise), on the device it is
handed.  The initial conditions are computed in float32, the precision the
configuration states for its fields (their FFTs at 768^3 lose about 1e-4 of
the velocities' L2 norm against float64, enough to flip the ionization of
cells at its threshold, so a float64 reference could not tell a sound
float32 run from a bfloat16 one); the deposit accumulates, and every later
stage here computes, in float64.  The only things taken from elsewhere are the inputs
of the cell (the configuration's parameters, the node ladder, the seed) and
the background cosmology of `ref21cm.cosmology` (the linear P(k), the
growth factor and its rate, H(z), the comoving distance).

Conventions, as the cell defines its grids:
- grids are periodic cubes of n cells a side over the box length L; cell i
  is centred at i L / n, so hires cell h of a grid R times finer sits at
  h / R in lowres cells, and subsampling takes hires cell int(i R + 0.5);
- k_i = 2 pi m_i / L with m_i the FFT frequencies (numpy's order), and the
  forward transform unnormalised, the inverse carrying 1 / N.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

F64 = torch.float64
L_FACTOR = (4.0 * math.pi / 3.0) ** (-1.0 / 3.0)  # a cube's side over the tophat radius
T_CMB = 2.7255  # K at z = 0
DENSITY_FLOOR = -1.0 + 1e-7
# above this many hires cells the 2LPT source is formed on a grid of
# TRUNC_DIM cells a side from the modes that grid holds (the cell's
# stated treatment of large boxes, which bounds the memory of the 2LPT
# step); below it on the hires grid itself
TRUNC_MIN_CELLS = 640**3
TRUNC_DIM = 512


@dataclasses.dataclass
class ICs:
    """The initial conditions, on the device: the hires linear
    density (z = 0 normalisation), the lowres one, and the first- and
    second-order displacement fields (Mpc per unit growth) on the lowres
    grid."""

    hires_density: torch.Tensor
    lowres_density: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    vx_2LPT: torch.Tensor | None
    vy_2LPT: torch.Tensor | None
    vz_2LPT: torch.Tensor | None


def _check(inputs):
    so, mo = inputs.simulation_options, inputs.matter_options
    unsupported = {
        "NON_CUBIC_FACTOR": so.NON_CUBIC_FACTOR != 1.0,
        "PERTURB_ON_HIGH_RES": mo.PERTURB_ON_HIGH_RES,
        "SMOOTH_EVOLVED_DENSITY_FIELD": mo.SMOOTH_EVOLVED_DENSITY_FIELD,
        "V_CB_MODEL": mo.V_CB_MODEL != "NONE",
        "PERTURB_ALGORITHM": mo.PERTURB_ALGORITHM not in ("ZELDOVICH", "2LPT"),
        "DIM/HII_DIM": so.dim % so.HII_DIM != 0,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"the plain reference does not cover {bad}")


def _k(n, box_len, dev, dtype, half=False):
    m = np.fft.rfftfreq(n) * n if half else np.fft.fftfreq(n) * n
    return torch.as_tensor(2 * np.pi * m / box_len, dtype=dtype, device=dev)


def _kgrid(n, box_len, dev, dtype=F64):
    """(kx, ky, kz) broadcast over the half-space of an n^3 grid, and k^2."""
    kx = _k(n, box_len, dev, dtype)[:, None, None]
    ky = _k(n, box_len, dev, dtype)[None, :, None]
    kz = _k(n, box_len, dev, dtype, half=True)[None, None, :]
    return (kx, ky, kz), kx * kx + ky * ky + kz * kz


def _tophat(kr):
    """W(kR) of a real-space sphere, with its series at small kR."""
    small = kr < 1e-4
    x = torch.where(small, torch.ones_like(kr), kr)
    w = 3.0 * (torch.sin(x) - x * torch.cos(x)) / x**3
    return torch.where(small, 1.0 - kr * kr / 10.0, w)


def _subsample(field, n_out):
    idx = torch.as_tensor((np.arange(n_out) * (field.shape[0] / n_out) + 0.5).astype(np.int64),
                          device=field.device)
    return field[idx][:, idx][:, :, idx]


def _inv_ksq(ksq):
    return torch.where(ksq > 0, 1.0 / torch.where(ksq > 0, ksq, 1.0), 0.0)


def white_noise(shape, seed, dev):
    """The cell's Gaussian white noise: float32 draws of a torch.Generator
    on the device seeded with the run's seed, in the grid's C order."""
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)


def initial_conditions(inputs, dev, dtype=torch.float32) -> ICs:
    """Gaussian density of the configuration's linear P(k) from the seed's
    white noise, its lowres average, and the Zel'dovich and 2LPT
    displacements (Scoccimarro 1998, App. D) on the lowres grid, computed
    in `dtype`."""
    _check(inputs)
    so = inputs.simulation_options
    n, n_lo, L = so.dim, so.HII_DIM, float(so.box_len)
    r_lo = L_FACTOR * L / n_lo  # the tophat of a lowres cell
    cosmo = inputs.cosmology

    (kx, ky, kz), ksq = _kgrid(n, L, dev, dtype)
    kmag = torch.sqrt(ksq)
    # sqrt(P) on a fine ln k grid, linear in ln k between its points
    ln_k = np.linspace(np.log(2 * np.pi / L / 2), np.log(2 * np.pi / L * n * np.sqrt(3.0)), 65537)
    sqrt_p = torch.as_tensor(np.sqrt(cosmo.power_in_k(np.exp(ln_k))), dtype=dtype, device=dev)
    t = (torch.log(torch.where(kmag > 0, kmag, 1.0)) - ln_k[0]) / (ln_k[1] - ln_k[0])
    t = t.clamp(0, len(ln_k) - 1.000001)
    i0 = t.long()
    amp = sqrt_p[i0] + (t - i0) * (sqrt_p[i0 + 1] - sqrt_p[i0])
    amp = torch.where(kmag > 0, amp, 0.0) * math.sqrt(n**3 / L**3)
    del t, i0
    d_k = torch.fft.rfftn(white_noise((n, n, n), inputs.random_seed, dev).to(dtype)) * amp
    del amp
    hires = torch.fft.irfftn(d_k, s=(n, n, n))
    w_lo = _tophat(kmag * r_lo)
    del kmag
    lowres = _subsample(torch.fft.irfftn(d_k * w_lo, s=(n, n, n)), n_lo)
    inv = _inv_ksq(ksq) * w_lo
    vel = [_subsample(torch.fft.irfftn(d_k * (1j * k) * inv, s=(n, n, n)), n_lo)
           for k in (kx, ky, kz)]
    del inv, w_lo, ksq
    vel2 = [None, None, None]
    if inputs.matter_options.PERTURB_ALGORITHM == "2LPT":
        vel2 = _second_order(d_k, n, n_lo, L, r_lo)
    return ICs(hires, lowres, *vel, *vel2)


def _second_order(d_k, n, n_lo, L, r_lo):
    """psi2 = grad / lap of sum_{i<j} (phi_ii phi_jj - phi_ij^2), phi_ij the
    second derivatives of the potential of the linear density, smoothed
    by the lowres tophat and subsampled."""
    g = n
    if n**3 >= TRUNC_MIN_CELLS and TRUNC_DIM % n_lo == 0:
        # the modes of a TRUNC_DIM grid, rescaled for its 1/N
        g = TRUNC_DIM
        h = g // 2
        keep = torch.as_tensor(np.r_[0:h, n - h:n], device=d_k.device)
        d_k = d_k[keep][:, keep][:, :, :h + 1] * (g**3 / n**3)
    (kx, ky, kz), ksq = _kgrid(g, L, d_k.device, d_k.real.dtype)
    inv = _inv_ksq(ksq)
    ks = (kx, ky, kz)

    def phi(i, j):
        return torch.fft.irfftn(-d_k * (ks[i] * ks[j]) * inv, s=(g, g, g))

    diag = [phi(a, a) for a in range(3)]
    src = diag[0] * diag[1] + diag[0] * diag[2] + diag[1] * diag[2]
    del diag
    for i, j in ((0, 1), (0, 2), (1, 2)):
        src -= phi(i, j) ** 2
    s_k = torch.fft.rfftn(src)
    del src
    w = inv * _tophat(torch.sqrt(ksq) * r_lo)
    return [_subsample(torch.fft.irfftn(s_k * (1j * k) * w, s=(g, g, g)), n_lo) for k in ks]


def perturb(z, inputs, ics: ICs, slab=64):
    """(density, v_z) on the lowres grid at `z`: every hires cell a particle
    of mass 1 + delta D(z_init), moved by the growth of its nearest lowres
    cell's displacements, D(z) - D(z_init) of the first order and
    -3/7 (D(z)^2 - D(z_init)^2) of the second, deposited cloud-in-cell
    (periodic); the LOS velocity of linear theory, dD/dt / D i k_z / k^2
    delta(k), in Mpc/s."""
    so = inputs.simulation_options
    cosmo = inputs.cosmology
    n, n_lo, L = so.dim, so.HII_DIM, float(so.box_len)
    R = n // n_lo
    dev = ics.hires_density.device
    D = float(cosmo.dicke(z))
    D0 = float(cosmo.dicke(so.INITIAL_REDSHIFT))
    f1 = (D - D0) * n_lo / L
    f2 = (-3.0 / 7.0) * (D**2 - D0**2) * n_lo / L
    disp = []
    for a, v in enumerate((ics.vx, ics.vy, ics.vz)):
        d = v.double() * f1
        v2 = (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT)[a]
        if v2 is not None:
            d = d - v2.double() * f2
        disp.append(d)

    h = torch.arange(n, device=dev, dtype=F64)
    near = torch.remainder(torch.floor(h / R + 0.5).long(), n_lo)
    acc = torch.zeros(n_lo**3, dtype=F64, device=dev)
    for x0 in range(0, n, slab):
        rows = slice(x0, min(n, x0 + slab))
        cx = near[rows]
        pos = [h[rows, None, None] / R + disp[0][cx][:, near][:, :, near],
               h[None, :, None] / R + disp[1][cx][:, near][:, :, near],
               h[None, None, :] / R + disp[2][cx][:, near][:, :, near]]
        mass = 1.0 + ics.hires_density[rows].double() * D0
        corner = []
        for p in pos:
            p = p.expand(mass.shape)
            lo = torch.floor(p)
            f = p - lo
            lo = torch.remainder(lo.long(), n_lo)
            corner.append(((lo, 1.0 - f), (torch.remainder(lo + 1, n_lo), f)))
        del pos
        for ix, wx in corner[0]:
            for iy, wy in corner[1]:
                for iz, wz in corner[2]:
                    acc.index_add_(0, ((ix * n_lo + iy) * n_lo + iz).reshape(-1),
                                   (mass * wx * wy * wz).reshape(-1))
        del corner, mass
    delta = acc.reshape(n_lo, n_lo, n_lo) * (n_lo**3 / n**3) - 1.0
    del acc
    d_k = torch.fft.rfftn(delta)
    (_, _, kz), ksq = _kgrid(n_lo, L, dev)
    rate = float(cosmo.ddicke_dt(z)) / D
    v_z = torch.fft.irfftn(d_k * (1j * kz * rate) * _inv_ksq(ksq), s=(n_lo,) * 3)
    return delta.clamp_min(DENSITY_FLOOR), v_z


def brightness(inputs, z, xh, delta, ts=None):
    """(T_b in mK, tau_21): the optically thin T_b of a saturated spin
    temperature without `ts`; with it the optical depth
    tau = T_b^thin (1+z) / (1000 T_s) and T_b = (1 - e^-tau) (T_s - T_cmb) 1000 / (1+z)."""
    cp = inputs.cosmo_params
    thin = 27.0 * (cp.OMb * cp.hlittle**2 / 0.023) * math.sqrt(
        0.15 / (cp.OMm * cp.hlittle**2) * (1.0 + z) / 10.0) * xh * (1.0 + delta)
    if ts is None:
        return thin, None
    tau = thin * (1.0 + z) / (1000.0 * ts)
    return -torch.expm1(-tau) * 1000.0 * (ts - T_CMB * (1.0 + z)) / (1.0 + z), tau


def slice_distances(inputs, z_min, z_max):
    """The cone's comoving distances: one lowres cell apart from d(z_min)."""
    cosmo = inputs.cosmology
    res = inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM
    d_min, d_max = cosmo.comoving_distance(z_min), cosmo.comoving_distance(z_max)
    return d_min + np.arange(int(np.floor((d_max - d_min) / res)) + 1) * res


def slice_redshifts(inputs, dists):
    """The redshift of each distance, by inverting d(z) on a fine grid."""
    z = np.linspace(0.0, 60.0, 600001)
    return np.interp(dists, inputs.cosmology.comoving_distance(z), z)


def slices(inputs, dists, d_lo, d_hi, box_lo, box_hi):
    """(indices, values) of the slices in [d_lo, d_hi): each the box's LOS
    plane nearest its distance (periodic), linear in distance between the
    lower-redshift box `box_lo` and the higher one; None where none falls."""
    idx = np.nonzero((dists >= d_lo) & (dists < d_hi))[0]
    if idx.size == 0:
        return None, None
    cell = inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM
    pix = torch.as_tensor(np.round(dists[idx] / cell).astype(np.int64) % box_lo.shape[2],
                          device=box_lo.device)
    w = torch.as_tensor((dists[idx] - d_lo) / (d_hi - d_lo), dtype=F64, device=box_lo.device)
    return idx, box_lo[:, :, pix] * (1 - w) + box_hi[:, :, pix] * w


def _d_dr(field, dx):
    """d/dr along the last axis: second-order differences, one-sided at
    the ends."""
    mid = (field[..., 2:] - field[..., :-2]) / (2 * dx)
    first = (-3 * field[..., :1] + 4 * field[..., 1:2] - field[..., 2:3]) / (2 * dx)
    last = (3 * field[..., -1:] - 4 * field[..., -2:-1] + field[..., -3:-2]) / (2 * dx)
    return torch.cat([first, mid, last], dim=-1)


def include_dvdr(inputs, tb, v_z, z, tau=None):
    """The velocity gradient in the 21-cm optical depth, tau -> tau /
    |1 + dv/dr / H|: optically thin, T_b / |1 + dv/dr / H| with dv/dr held
    within MAX_DVDR H; with tau_21, T_b (1 - e^{-tau/g}) / (1 - e^{-tau})."""
    dx = inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM
    H = torch.as_tensor(inputs.cosmology.hubble(z), dtype=F64, device=tb.device)
    grad = _d_dr(v_z, dx)
    if tau is None:
        lim = H * float(inputs.astro_params.MAX_DVDR)
        return tb / torch.abs(1.0 + torch.maximum(torch.minimum(grad, lim), -lim) / H)
    g = torch.abs(1.0 + grad / H)
    return tb * torch.where(tau < 1e-10, 1.0, torch.expm1(-tau / g) / torch.expm1(-tau))


def rsds(inputs, field, v_z, z, n_sub=4, rows=4096):
    """Each LOS cell split into `n_sub` parts of equal weight, each moved by
    v_z / (H a cell) cells, the displacement linear between cell centres
    (held at the ends), and deposited cloud-in-cell on the sub-cell grid,
    not periodic (clamped at the ends), then summed back into cells."""
    cell = inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM
    dev = field.device
    n = field.shape[-1]
    H = torch.as_tensor(inputs.cosmology.hubble(z), dtype=F64, device=dev)
    shape = field.shape
    field = field.reshape(-1, n)
    disp = (v_z / (H * cell)).reshape(-1, n)
    centre = (torch.arange(n * n_sub, dtype=F64, device=dev) + 0.5) / n_sub  # in cells
    t = (centre - 0.5).clamp(0, n - 1)
    j = t.floor().long().clamp(max=n - 2)
    f = t - j
    out = torch.empty_like(field)
    for r0 in range(0, field.shape[0], rows):
        d = disp[r0:r0 + rows]
        d_sub = d[:, j] * (1 - f) + d[:, j + 1] * f
        pos = (centre + d_sub) * n_sub - 0.5  # sub-cell units, centres at integers
        lo = pos.floor()
        frac = pos - lo
        lo = lo.long()
        part = field[r0:r0 + rows, :].repeat_interleave(n_sub, dim=1) / n_sub
        acc = torch.zeros_like(part)
        acc.scatter_add_(1, lo.clamp(0, n * n_sub - 1), part * (1 - frac))
        acc.scatter_add_(1, (lo + 1).clamp(0, n * n_sub - 1), part * frac)
        out[r0:r0 + rows] = acc.reshape(-1, n, n_sub).sum(dim=2)
    return out.reshape(shape)
