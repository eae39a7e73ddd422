#!/usr/bin/env python3
"""Drive py21cmfast_torch on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel in py21cmfast_torch/csrc (one nvcc per source,
     in parallel), with ptxas's register report;
  3. each kernel against its plain PyTorch version on the card: edge cases
     and the main path's own inputs, with CUDA-event timings of the kernel
     and its plain version, and the share of the deposits that bypass the
     kernel's shared-memory tile;
  4. a golden-size coeval (HII_DIM=24) on the card against the same coeval on
     the CPU, from the same hires density;
  4b. the same for PERTURB_DEPOSIT="SCATTER" and PERTURB_ON_HIGH_RES, which
     reach the same kernel, and PERTURB_ON_HIGH_RES at the main path's size;
  5. the main path: run_coeval of the simple+size-medium template
     (HII_DIM=128, DIM=384, 256 Mpc) at z=10 and z=8, with every kernel's
     launch count zeroed just before and read just after;
  6. warm per-stage times of the same coeval, and each stage's device-busy
     time from a second pass under torch.profiler.
The line before the last is a JSON object of kernel numbers; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 7
MAIN_TEMPLATE = "simple+size-medium"
MAIN_REDSHIFTS = [10.0, 8.0]
GOLDEN_SIZE = dict(
    HII_DIM=24, DIM=72, BOX_LEN=36.0, ZPRIME_STEP_FACTOR=1.25, Z_HEAT_MAX=25.0,
    SOURCE_MODEL="E-INTEGRAL",
)
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor fp32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# float operations per sub-particle of the CIC deposit as a function: position
# (3 adds + 3 adds + 3 divides), mass (1 fma = 2), floor and fraction (6), 1-f
# (3), the 8 weight products (16) and the 8 adds
DEPOSIT_FLOPS_PER_PARTICLE = 44


def _sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _event_median_ms(fn, reps, warmup=2):
    """Median of `reps` CUDA-event timings of one call each, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def card_info():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}"
    )


def build_kernels():
    from py21cmfast_torch import _kernels

    t0 = time.perf_counter()
    logs = _kernels.build()
    print(f"[build] {len(logs)} of {len(_kernels.sources())} sources compiled in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            # ptxas names the function, then its stack and spills, then registers
            if "Compiling entry function" in line and "kernelILi3E" in line:
                print(f"[build] {name}: {line.split(chr(39))[1]}: "
                      + "; ".join(x.strip() for x in lines[i + 1:i + 4] if "bytes" in x or "registers" in x))
    _print_shared_atomic_opcodes()


def _print_shared_atomic_opcodes():
    """How the card's compiler lowered the adds of the R = 3 kernel: count the
    atomic opcodes in its SASS (cuobjdump).  The tile's adds must be native
    integer ones (ATOMS.ADD), with no compare-and-swap loop (ATOMS.CAST.SPIN),
    which is what a float atomicAdd on shared memory becomes."""
    import collections
    import re
    import shutil

    from py21cmfast_torch import _kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_kernels.library_path("cic_deposit"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    bodies = [b for b in sass.split("Function : ")[1:] if "kernelILi3E" in b.split()[0]]
    if len(bodies) != 1:
        raise AssertionError(f"expected one R = 3 kernel in the SASS, found {len(bodies)}")
    ops = collections.Counter(re.findall(r"\b(ATOMS[.\w]*|REDS?[.\w]*|ATOMG[.\w]*|REDG[.\w]*)", bodies[0]))
    print(f"[build] SASS {bodies[0].split()[0]}: {dict(ops)}")
    if ops["ATOMS.ADD"] < 27 or any("CAS" in op for op in ops):
        raise AssertionError(f"the tile's 27 adds are not native integer adds: {dict(ops)}")


# the kernel's brick of channel cells per block, at ratio 1 and above, and its
# halo (H cells below the brick, H + 1 above), as csrc/cic_deposit.cu sets them
DEPOSIT_BRICK_RATIO1, DEPOSIT_BRICK, DEPOSIT_HALO = (16, 16, 16), (8, 8, 32), 3


def global_path_share(d, ratio):
    """Share of the sub-particles whose deposits bypass the kernel's
    shared-memory tile and go to global memory, computed with torch from the
    displacement fields by the kernel's own rule (csrc/cic_deposit.cu).
    Ratio above 1: a channel's 27 sums go global when on some axis the 3-cell
    stencil that starts at floor(c + d + s_first/R) leaves the tile of the
    brick that holds c (`tile_coordinate`), or spans more than 3 cells
    (`stencil_base`).  Ratio 1: a particle goes global when on some axis its
    2 cells from floor(c + d) leave the tile."""
    import torch

    brick, halo = DEPOSIT_BRICK_RATIO1 if ratio == 1 else DEPOSIT_BRICK, DEPOSIT_HALO
    residuals = [float(np.float32(s - ratio // 2) / np.float32(ratio)) for s in range(ratio)]
    inside = 1.0
    for axis, (da, b) in enumerate(zip(d, brick)):
        shape = [1, 1, 1]
        shape[axis] = da.shape[axis]
        c = torch.arange(da.shape[axis], device=da.device)
        q = c.to(torch.float32).reshape(shape) + da
        origin = (torch.div(c, b, rounding_mode="floor") * b - halo).to(torch.float32).reshape(shape)
        extent = b + 2 * halo + 1
        if ratio > 1:
            base = torch.floor(q + residuals[0])
            t = base - origin
            ok = (t >= 0) & (t <= extent - 3) & (torch.floor(q + residuals[-1]) - base <= 1)
            inside = inside * ok.double()
        else:
            t = torch.floor(q) - origin
            inside = inside * ((t >= 0) & (t <= extent - 2)).double()
    return 1.0 - inside.mean().item()


def check_deposit(hires, d, d_init, ratio, label):
    """Kernel vs plain on the card (masses must be positive), cell by cell:
    |kernel - plain| <= 1e-5 max(plain_cell, mean(plain)), and the kernel's
    total mass equal to the plain total and to the exact particle mass within
    1e-6 relative (float64 sums).  Both sides add float32 atomics in a
    run-dependent order; the rounding of such a sum grows with the cell's own
    mass (the plain version adds ~1700 single terms into a cell of 8x the mean
    mass at the main-path shape, at an ulp of 1.5e-5), so the bound follows
    the cell where it holds more than the mean."""
    import torch

    from py21cmfast_torch.ops import deposit

    plain = deposit.cic_deposit_swept_plain(hires, *d, d_init, ratio)
    got = deposit.cic_deposit_swept(hires, *d, d_init, ratio)
    torch.cuda.synchronize()
    diff = (got - plain).abs()
    err = diff.max().item()
    mean = plain.double().mean().item()
    worst = (diff / torch.clamp_min(plain, mean)).max().item()
    tot_k, tot_p = got.double().sum().item(), plain.double().sum().item()
    tot_exact = (1.0 + hires.double() * d_init).sum().item()
    ok = (
        worst <= 1e-5
        and abs(tot_k - tot_p) <= 1e-6 * abs(tot_p)
        and abs(tot_k - tot_exact) <= 1e-6 * abs(tot_exact)
    )
    share = global_path_share(d, ratio)
    print(f"[deposit] {label}: "
          f"max|kernel-plain| {err:.3e} (mean mass {mean:.3f}), "
          f"max |kernel-plain|/max(plain, mean) {worst:.3e} (limit 1e-5), "
          f"mass kernel {tot_k:.9e} plain {tot_p:.9e} exact {tot_exact:.9e}, "
          f"global-path share {share:.3e} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"cic_deposit_swept disagrees with its plain version ({label})")
    return err, worst


# (lowres shape, ratios, mean and sigma of the displacement in cells): extents
# below the tile and off the brick's multiples, R = 1, even and odd R, a ratio
# without a compiled-in loop (5), zero displacement, negative positions, and
# sigma = 6 and 12 cells, where 40% and 80% of the deposits take the global path
DEPOSIT_CASES = [
    ((16, 16, 24), (1, 2, 3, 4, 5), 0.0, 2.0),
    ((4, 6, 10), (2, 3), 0.0, 2.0),
    ((24, 24, 24), (3,), 0.0, 0.6),
    ((20, 17, 33), (2, 3), 0.0, 0.0),
    ((20, 17, 33), (1, 3), -7.5, 1.0),
    ((40, 24, 36), (1, 2, 3), 0.0, 6.0),
    ((40, 24, 36), (1, 3), 0.0, 12.0),
]


def kernel_phase():
    """The edge cases, then the main path's own z=8 inputs with timings of
    the kernel and its plain version."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import perturb
    from py21cmfast_torch.ops import deposit

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for lo, ratios, mu, sigma in DEPOSIT_CASES:
        for R in ratios:
            hires = torch.from_numpy(
                rng.normal(0, 0.3, tuple(R * n for n in lo)).astype(np.float32)).to(dev)
            d = [torch.from_numpy(rng.normal(mu, sigma, lo).astype(np.float32)).to(dev)
                 for _ in range(3)]
            check_deposit(hires, d, 0.5, R, f"R={R} lowres {lo}, d ~ N({mu}, {sigma}) cells")
    # masses of ~70 R^3 per channel: cells of the fixed-point tile wrap past
    # 2^31 units (256 mean cell masses), and the heaviest channels exceed what
    # a thread may convert and take the global path
    for R in (1, 3):
        lo = (20, 17, 33)
        hires = torch.from_numpy(
            np.abs(rng.normal(0, 180.0, tuple(R * n for n in lo))).astype(np.float32)).to(dev)
        d = [torch.from_numpy(rng.normal(0, 0.6, lo).astype(np.float32)).to(dev) for _ in range(3)]
        check_deposit(hires, d, 0.5, R, f"R={R} lowres {lo}, heavy masses")

    inputs = p21.InputParameters.from_template(MAIN_TEMPLATE, random_seed=SEED)
    so = inputs.simulation_options
    ics = p21.compute_initial_conditions(inputs)
    _, D_init, fac_za, fac_2lpt = perturb._displacement_factors(inputs, 8.0)
    d = perturb._displacement_cells(
        (ics.vx, ics.vy, ics.vz), (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT),
        fac_za, fac_2lpt, tuple(n / L for n, L in zip(so.lowres_shape, so.box_lens)),
    )
    ratio = so.hires_shape[0] // so.lowres_shape[0]
    d_init = float(np.float32(D_init))
    hires = ics.hires_density
    print(f"[deposit] main path z=8: displacement rms per axis "
          f"{[round(x.std().item(), 4) for x in d]} cells, max |d| "
          f"{max(x.abs().max().item() for x in d):.3f} cells")
    err, worst = check_deposit(hires, d, d_init, ratio, f"main path z=8 hires {so.hires_shape}")

    def kernel():
        return deposit.cic_deposit_swept(hires, *d, d_init, ratio)

    def batched_ms(n=50):
        """n launches between one pair of events: the kernel with the zeroing
        of its output, without the host's time to enqueue a single call."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        kernel()
        start.record()
        for _ in range(n):
            kernel()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    def host_call_ms(n=200):
        """Host clock over n wrapper calls that nothing waits for: what one
        call costs the host before its launch is enqueued (argument checks,
        the output's allocation, the ctypes call)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            kernel()
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e3 * seconds / n

    # kernel, plain, kernel again: one card, in turns.  The kernel's time is
    # the median of single calls, each between its own pair of events, so it
    # holds the host's time to enqueue one call; the time of a call in a run
    # of launches stands beside it.
    kernel_ms, batch_ms = _event_median_ms(kernel, 20), batched_ms()
    plain_ms = _event_median_ms(lambda: deposit.cic_deposit_swept_plain(hires, *d, d_init, ratio), 10)
    host_ms = host_call_ms()
    print(f"[deposit] kernel again: {_event_median_ms(kernel, 20):.4f} ms (median of 20 single "
          f"calls), {batched_ms():.4f} ms a call in a run of 50; the host spends {host_ms:.4f} ms "
          f"on a call (200 calls, not waited for)")
    n_lo = int(np.prod(so.lowres_shape))
    n_bytes = 4 * (hires.numel() + 3 * n_lo + n_lo)
    n_ops = DEPOSIT_FLOPS_PER_PARTICLE * hires.numel()
    bytes_ms, ops_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * n_ops / PEAK_FP32_FLOPS
    print(f"[deposit] main-path shape: kernel {kernel_ms:.4f} ms (median of 20 single calls; "
          f"{batch_ms:.4f} ms a call in a run of 50), plain {plain_ms:.4f} ms "
          f"(median of 10 single calls), all by CUDA events; bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms, {n_ops / 1e9:.2f} GFLOP -> "
          f"{ops_ms:.4f} ms); worst per-cell error {worst:.3e} of the cell's mass")
    return {
        "name": "cic_deposit_swept",
        "route": "cuda",
        "source": "py21cmfast_torch/csrc/cic_deposit.cu",
        "replaces": "py21cmfast_tpu/ops/pallas_deposit.py:101",
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "batched_ms": batch_ms,
        "host_call_ms": host_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes a CIC deposit
    }


def _card_vs_cpu_coeval(label, **over):
    """A golden-size coeval on the card against the CPU, both from the same
    hires density (the two generators draw different noise)."""
    import py21cmfast_torch as p21
    from py21cmfast_torch.ops import deposit

    inputs = p21.InputParameters(random_seed=SEED).evolve_input_structs(**GOLDEN_SIZE, **over)
    ics_cpu = p21.compute_initial_conditions(inputs, device="cpu")
    ics_gpu = p21.compute_initial_conditions(
        inputs, initial_density=ics_cpu.hires_density.numpy()
    )
    for name in ("lowres_density", "vx", "vy", "vz", "vx_2LPT", "vy_2LPT", "vz_2LPT"):
        a = getattr(ics_cpu, name)
        b = getattr(ics_gpu, name).cpu()
        err, scale = (a - b).abs().max().item(), a.abs().max().item()
        if a.shape != b.shape or not err <= 1e-5 * scale:
            raise AssertionError(
                f"{label} ICs {name}: card vs CPU max-abs {err:.3e} > 1e-5 x {scale:.3e}")
    cpu = p21.run_coeval(inputs, 10.5, initial_conditions=ics_cpu, device="cpu")
    launches = deposit.cic_deposit_swept.launches
    gpu = p21.run_coeval(inputs, 10.5, initial_conditions=ics_gpu)
    if deposit.cic_deposit_swept.launches != launches + 1:
        raise AssertionError(f"{label}: the coeval on the card did not launch the deposit kernel once")
    dens_c, dens_g = cpu.density, gpu.density.cpu()
    d_err = (dens_c - dens_g).abs().max().item()
    xh_c, xh_g = cpu.neutral_fraction, gpu.neutral_fraction.cpu()
    flipped = ((xh_c - xh_g).abs() > 1e-3).double().mean().item()
    gx_c, gx_g = xh_c.double().mean().item(), xh_g.double().mean().item()
    tb_c, tb_g = cpu.brightness_temp.double().mean().item(), gpu.brightness_temp.double().mean().item()
    print(f"[small] {label} z=10.5 HII_DIM=24, velocities on {tuple(ics_gpu.vx.shape)}: "
          f"density max-abs {d_err:.3e} (std {dens_c.std().item():.3f}), "
          f"xH {gx_g:.6f} card vs {gx_c:.6f} CPU, flipped share {flipped:.2e}, "
          f"mean Tb {tb_g:.5f} vs {tb_c:.5f} mK")
    ok = (
        d_err <= 1e-4 * dens_c.std().item()
        and abs(gx_g - gx_c) <= 5e-3
        and flipped <= 1e-3
        and abs(tb_g - tb_c) <= 0.05 + 5e-3 * abs(tb_c)
    )
    if not ok:
        raise AssertionError(f"the golden-size coeval on the card disagrees with the CPU run ({label})")
    return dens_g


def small_coeval_phase():
    """The golden-size "simple" coeval (SWEPT deposit) on the card against the CPU."""
    return _card_vs_cpu_coeval("simple")


def perturb_paths_phase(dens_swept):
    """The other integer-ratio perturb paths through the same kernel, each a
    golden-size coeval on the card against the CPU: PERTURB_DEPOSIT="SCATTER"
    (the same function as SWEPT, so the same field on the same density) and
    PERTURB_ON_HIGH_RES (ratio 1 onto the hires grid, then filter and
    subsample).  Then the PERTURB_ON_HIGH_RES perturb at the main path's size,
    384^3 onto 384^3, with the kernel's time there."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import perturb
    from py21cmfast_torch.ops import deposit

    dens_scatter = _card_vs_cpu_coeval("SCATTER", PERTURB_DEPOSIT="SCATTER")
    err = (dens_scatter - dens_swept).abs().max().item()
    print(f"[small] SCATTER vs SWEPT density on the card: max-abs {err:.3e}")
    if not err <= 1e-4 * dens_swept.std().item():
        raise AssertionError("SCATTER and SWEPT give different densities on the card")
    _card_vs_cpu_coeval("PERTURB_ON_HIGH_RES", PERTURB_ON_HIGH_RES=True)

    inputs = p21.InputParameters.from_template(
        MAIN_TEMPLATE, random_seed=SEED).evolve_input_structs(PERTURB_ON_HIGH_RES=True)
    so = inputs.simulation_options
    ics = p21.compute_initial_conditions(inputs)
    p21.perturb_field(8.0, inputs, ics)
    pf, seconds = _sync_time(lambda: p21.perturb_field(8.0, inputs, ics))
    if tuple(pf.density.shape) != so.lowres_shape or not bool(torch.isfinite(pf.density).all()):
        raise AssertionError("PERTURB_ON_HIGH_RES at the main path's size: bad density")
    _, D_init, fac_za, fac_2lpt = perturb._displacement_factors(inputs, 8.0)
    d = perturb._displacement_cells(
        (ics.vx, ics.vy, ics.vz), (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT),
        fac_za, fac_2lpt, tuple(n / L for n, L in zip(so.hires_shape, so.box_lens)),
    )
    d_init = float(np.float32(D_init))
    check_deposit(ics.hires_density, d, d_init, 1, f"PERTURB_ON_HIGH_RES z=8 hires {so.hires_shape}")
    ms = _event_median_ms(lambda: deposit.cic_deposit_swept(ics.hires_density, *d, d_init, 1), 10)
    print(f"[hires] PERTURB_ON_HIGH_RES z=8 at {so.hires_shape} -> {so.hires_shape}: warm perturb "
          f"{seconds * 1e3:.2f} ms wall, deposit kernel {ms:.4f} ms (median of 10 single calls), "
          f"global-path share {global_path_share(d, 1):.3e}; byte bound "
          f"{1e3 * 4 * 5 * ics.hires_density.numel() / PEAK_BYTES_PER_S:.4f} ms; displacement "
          f"rms per axis {[round(x.std().item(), 3) for x in d]} hires cells, density std "
          f"{pf.density.std().item():.5f}")


def main_path_phase(kernels):
    """run_coeval of the main path; launch counts zeroed just before."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.ops import deposit

    wrappers = {"cic_deposit_swept": deposit.cic_deposit_swept}
    inputs = p21.InputParameters.from_template(MAIN_TEMPLATE, random_seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    coevals, seconds = _sync_time(lambda: p21.run_coeval(inputs, MAIN_REDSHIFTS))
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"[main] run_coeval({MAIN_TEMPLATE}, {MAIN_REDSHIFTS}) on the card: {seconds:.3f} s "
          f"(first call), launches {launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"the main path never launched {k['name']}")
    if launches["cic_deposit_swept"] != len(MAIN_REDSHIFTS):
        raise AssertionError(f"expected {len(MAIN_REDSHIFTS)} deposit launches, got {launches}")

    lo = inputs.simulation_options.lowres_shape
    xh = {}
    for cv in coevals:
        for struct in (cv.perturbed_field, cv.ionized_box, cv.brightness_temperature):
            for name, v in vars(struct).items():
                if isinstance(v, torch.Tensor):
                    if tuple(v.shape) != lo or not v.is_cuda:
                        raise AssertionError(f"{name} at z={cv.redshift}: {tuple(v.shape)} on {v.device}")
                    if not bool(torch.isfinite(v).all()):
                        raise AssertionError(f"{name} at z={cv.redshift} is not finite")
        x = cv.neutral_fraction
        if not (0.0 <= x.min().item() and x.max().item() <= 1.0):
            raise AssertionError(f"xH out of [0, 1] at z={cv.redshift}")
        xh[cv.redshift] = x.double().mean().item()
        print(f"[main] z={cv.redshift:5.2f}: global xH {xh[cv.redshift]:.6f}, "
              f"mean Tb {cv.brightness_temp.double().mean().item():.5f} mK, "
              f"density std {cv.density.std().item():.5f}")
    if not xh[8.0] < xh[10.0]:
        raise AssertionError(f"xH does not fall from z=10 to z=8: {xh}")


def _device_busy_ms(fn):
    """Run `fn` under torch.profiler; return the union of its device
    activity intervals in ms and the three busiest kernels, or None where
    the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _sync_time(fn)
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return None
    busy, end, by_name = 0.0, -np.inf, {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return busy / 1e3, [(n[:60], round(t / 1e3, 4)) for n, t in top]


def stage_phase():
    """Warm, synchronised per-stage times of the main path's coeval, then the
    device-busy time of each stage from a second, profiled pass."""
    import py21cmfast_torch as p21

    inputs = p21.InputParameters.from_template(MAIN_TEMPLATE, random_seed=SEED)
    ics, t = _sync_time(lambda: p21.compute_initial_conditions(inputs))
    stages = [("ICs", t, lambda: p21.compute_initial_conditions(inputs))]
    for z in MAIN_REDSHIFTS:
        pf, t_pf = _sync_time(lambda: p21.perturb_field(z, inputs, ics))
        ion, t_ion = _sync_time(lambda: p21.compute_ionization_field(z, inputs, pf))
        _, t_tb = _sync_time(lambda: p21.brightness_temperature(inputs, ion, pf))
        stages += [
            (f"perturb z={z}", t_pf, lambda z=z: p21.perturb_field(z, inputs, ics)),
            (f"ionize z={z}", t_ion, lambda z=z, pf=pf: p21.compute_ionization_field(z, inputs, pf)),
            (f"Tb z={z}", t_tb, lambda pf=pf, ion=ion: p21.brightness_temperature(inputs, ion, pf)),
        ]
    for name, wall, fn in stages:
        busy = _device_busy_ms(fn)
        busy_txt = (
            "device busy not measured (the profiler saw no device activity)" if busy is None
            else f"device busy {busy[0]:.3f} ms ({100 * busy[0] / (wall * 1e3):.1f}% of the "
                 f"unprofiled wall), top kernels {busy[1]}"
        )
        print(f"[stages] {name}: {wall * 1e3:.2f} ms wall; {busy_txt}")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this check runs only on an NVIDIA GPU")
    import py21cmfast_torch  # noqa: F401  (fails outside a checkout of the repository)

    t0 = time.perf_counter()
    card_info()
    build_kernels()
    kernels = [kernel_phase()]
    dens_swept = small_coeval_phase()
    perturb_paths_phase(dens_swept)
    main_path_phase(kernels)
    stage_phase()
    print(f"[total] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
