#!/usr/bin/env python3
"""Drive py21cmfast_torch on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel in py21cmfast_torch/csrc (one nvcc per source,
     in parallel), with ptxas's register report;
  3. each kernel against its plain PyTorch version on the card: edge cases
     and the perturb's own inputs at the simple coeval's shape (384^3 ->
     128^3) and at the headline lightcone's (768^3 -> 256^3, whose ICs are
     computed and timed here), with CUDA-event timings of the kernel and its
     plain version, and the share of the deposits that bypass the kernel's
     shared-memory tile;
  4. a golden-size coeval (HII_DIM=24) on the card against the same coeval on
     the CPU, from the same hires density;
  4b. the same for PERTURB_DEPOSIT="SCATTER" and PERTURB_ON_HIGH_RES, which
     reach the same kernel, and PERTURB_ON_HIGH_RES at the main path's size;
  4c. the golden-size evolving coeval (USE_TS_FLUCT, inhomogeneous
     recombinations, 5 nodes down to z=10.5) on the card against the CPU:
     Ts, Tk, x_e, N_rec, xH and Tb;
  4d. golden-size lightcones with dvdr and RSDs (the golden "lightcone"
     configuration, saturated Ts, z=14.6 -> 9; and USE_TS_FLUCT +
     INHOMOGENEOUS, 5 nodes) on the card against the CPU: every cone per
     cell, the global quantities per node and the slices written;
  4e. the golden-size Munoz21 (EOS21) lightcone (minihalos, Lyman-Werner
     feedback, v_cb FLUCTS, USE_TS_FLUCT, inhomogeneous recombinations,
     SHARP-K, 5 nodes) on the card against the CPU from one hires density:
     the v_cb box, then per node Ts, Tk, x_e, J_21_LW, the Nion stacks, xH
     and Tb per cell and the turnover means, then the cones as in 4d;
  4f. golden-size L-INTEGRAL lightcones (the fixed-halos template; with
     minihalos; with minihalos and the Lya multiple-scattering window, whose
     Ts step reads straight-line LW shells), 5 nodes, on the card against
     the CPU from one hires density: per node the HaloBox grids, every
     XraySourceBox stack, Ts, Tk, x_e, J_21_LW, xH and Tb, then the cones as
     in 4d;
  5. the first main path: run_coeval of the simple+size-medium template
     (HII_DIM=128, DIM=384, 256 Mpc) at z=10 and z=8, with every kernel's
     launch count zeroed just before and read just after;
  6. warm per-stage times of the same coeval, and each stage's device-busy
     time from a second pass under torch.profiler;
  7. the second main path: the same template with USE_TS_FLUCT and
     inhomogeneous recombinations, evolved down its node ladder to z=8 (37
     nodes of ZPRIME_STEP_FACTOR=1.04)
     through generate_coeval, launch counts zeroed just before and read just
     after (one deposit launch per node), with the seconds per node, the host
     time of the Ts step and what the table prefetch hid of it;
  8. per-stage wall and device-busy times at three nodes of that scroll;
  9. the third main path, the repo's headline lightcone (bench.py:73-91:
     HII_DIM=256, DIM=768, BOX_LEN=384, USE_TS_FLUCT, inhomogeneous
     recombinations, 92 nodes from z=35.37 to z=5, 2566 slices) through
     generate_lightcone with the velocity-gradient correction and RSDs,
     launch counts zeroed just before and read just after (one deposit
     launch per node): seconds per node, the finalization's steps with their
     device-busy times, peak memory, a fully written finite cone, and the
     stages of the node nearest z=8;
  10. the fourth main path: the Munoz21 (EOS21) lightcone at the headline's
     box and ladder (256³/768³, 92 nodes to z=5, dvdr and RSDs), its ICs
     with the v_cb box timed first; as phase 9, with ⟨J_21_LW⟩ and the
     turnover means per node and the stages of the nodes nearest z=8 and
     z=15;
  11. the fifth main path: the fixed-halos template (L-INTEGRAL sources
     through the HaloBox and the XraySourceBox, USE_EXP_FILTER, CELL_RECOMB)
     at the headline's box and ladder, as phase 9: seconds per node, peak
     memory, 92 deposit launches, a fully written finite cone, and the node
     nearest z=8 by stage (the HaloBox's host tables, gathers and
     displacement scatter apart, the XraySourceBox, Ts, ionize, Tb), with
     CUDA-event times of the displacement scatter.
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


def _time_deposit(hires, d, d_init, ratio, label, reps=20):
    """Kernel against plain at one shape, then CUDA-event timings: the
    kernel's median of single calls (each between its own pair of events, so
    it holds the host's time to enqueue one call), a call in a run of 50, the
    host's time a call, the plain version's median, and the bound."""
    import torch

    from py21cmfast_torch.ops import deposit

    err, worst = check_deposit(hires, d, d_init, ratio, label)

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

    # kernel, plain, kernel again: one card, in turns
    kernel_ms, batch_ms = _event_median_ms(kernel, reps), batched_ms()
    plain_ms = _event_median_ms(lambda: deposit.cic_deposit_swept_plain(hires, *d, d_init, ratio),
                                max(3, reps // 2))
    host_ms = host_call_ms()
    print(f"[deposit] {label}, kernel again: {_event_median_ms(kernel, reps):.4f} ms (median of "
          f"{reps} single calls), {batched_ms():.4f} ms a call in a run of 50; the host spends "
          f"{host_ms:.4f} ms on a call (200 calls, not waited for)")
    n_lo = d[0].numel()
    n_bytes = 4 * (hires.numel() + 3 * n_lo + n_lo)
    n_ops = DEPOSIT_FLOPS_PER_PARTICLE * hires.numel()
    bytes_ms, ops_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * n_ops / PEAK_FP32_FLOPS
    print(f"[deposit] {label}: kernel {kernel_ms:.4f} ms (median of {reps} single calls; "
          f"{batch_ms:.4f} ms a call in a run of 50), plain {plain_ms:.4f} ms "
          f"(median of {max(3, reps // 2)} single calls), all by CUDA events; bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms, "
          f"{n_ops / 1e9:.2f} GFLOP -> {ops_ms:.4f} ms); worst per-cell error {worst:.3e} of "
          f"the cell's mass")
    return {
        "max_abs_err": err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "batched_ms": batch_ms,
        "host_call_ms": host_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def _main_path_deposit_inputs(inputs, ics, z):
    """The displacement fields (lowres cells), D_init and ratio that the
    perturb at z hands the deposit kernel."""
    from py21cmfast_torch.models import perturb

    so = inputs.simulation_options
    _, D_init, fac_za, fac_2lpt = perturb._displacement_factors(inputs, z)
    d = perturb._displacement_cells(
        (ics.vx, ics.vy, ics.vz), (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT),
        fac_za, fac_2lpt, tuple(n / L for n, L in zip(so.lowres_shape, so.box_lens)),
    )
    print(f"[deposit] {so.hires_shape} -> {so.lowres_shape} z={z}: displacement rms per axis "
          f"{[round(x.std().item(), 4) for x in d]} cells, max |d| "
          f"{max(x.abs().max().item() for x in d):.3f} cells")
    return d, float(np.float32(D_init)), so.hires_shape[0] // so.lowres_shape[0]


def kernel_phase():
    """The edge cases, then the perturb's own z=8 inputs at the simple
    coeval's shape (384^3 -> 128^3) and at the headline lightcone's (768^3 ->
    256^3), with timings of the kernel and its plain version.  Returns the
    kernel's entry (headline-shape numbers at its top level) and the headline
    ICs, whose first computation is timed here."""
    import torch

    import py21cmfast_torch as p21

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

    by_shape = {}
    inputs = p21.InputParameters.from_template(MAIN_TEMPLATE, random_seed=SEED)
    ics = p21.compute_initial_conditions(inputs)
    d, d_init, ratio = _main_path_deposit_inputs(inputs, ics, 8.0)
    by_shape["384^3->128^3"] = _time_deposit(
        ics.hires_density, d, d_init, ratio, f"simple coeval z=8 hires {inputs.simulation_options.hires_shape}")
    del ics, d

    inputs = _headline_inputs()
    ics, ics_s = _sync_time(lambda: p21.compute_initial_conditions(inputs))
    print(f"[deposit] headline ICs at {inputs.simulation_options.hires_shape} -> "
          f"{inputs.simulation_options.lowres_shape}: {ics_s:.3f} s (first call, synchronised), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    d, d_init, ratio = _main_path_deposit_inputs(inputs, ics, 8.0)
    by_shape["768^3->256^3"] = _time_deposit(
        ics.hires_density, d, d_init, ratio,
        f"headline lightcone z=8 hires {inputs.simulation_options.hires_shape}", reps=10)
    del d
    torch.cuda.empty_cache()
    entry = {
        "name": "cic_deposit_swept",
        "route": "cuda",
        "source": "py21cmfast_torch/csrc/cic_deposit.cu",
        "replaces": "py21cmfast_tpu/ops/pallas_deposit.py:101",
        "launches": None,
        **by_shape["768^3->256^3"],
        "library_ms": None,  # no single PyTorch call computes a CIC deposit
        "by_shape": by_shape,
    }
    return entry, (inputs, ics, ics_s)


def _card_vs_cpu_coeval(label, nodes=False, **over):
    """A golden-size coeval on the card against the CPU, both from the same
    hires density (the two generators draw different noise).  With `nodes`
    the coeval evolves down the golden ladder (25 -> 10.5, 5 nodes)."""
    import py21cmfast_torch as p21
    from py21cmfast_torch.ops import deposit

    inputs = p21.InputParameters(random_seed=SEED).evolve_input_structs(**GOLDEN_SIZE, **over)
    if nodes:
        inputs = inputs.with_logspaced_redshifts(10.5, 25.0)
    n_nodes = max(1, len(inputs.node_redshifts))
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
    if deposit.cic_deposit_swept.launches != launches + n_nodes:
        raise AssertionError(
            f"{label}: the coeval on the card did not launch the deposit kernel once per node")
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
    if gpu.spin_temp is not None:
        _card_vs_cpu_thermal(label, cpu, gpu)
    return dens_g


def _card_vs_cpu_thermal(label, cpu, gpu):
    """Ts, Tk, x_e of the last node, card against CPU: every cell within 1e-3
    of its own value and the mean within 1e-4 (float32 chains of 5 nodes
    through two FFT and two math libraries).  N_rec: mean within 5e-3, and at
    most 1e-3 of the cells differ by more than 1e-3 of the maximum (a cell's
    row of the rate table is the nearest neighbour in z_eff, and thresholded
    xH multiplies the increment)."""
    for name in ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction"):
        c = getattr(cpu.spin_temp, name).double()
        g = getattr(gpu.spin_temp, name).cpu().double()
        rel = ((c - g).abs() / c.abs()).max().item()
        mean_rel = abs(g.mean().item() - c.mean().item()) / abs(c.mean().item())
        print(f"[small] {label} {name}: mean {g.mean().item():.6g} card vs {c.mean().item():.6g} CPU "
              f"(rel {mean_rel:.2e}, limit 1e-4), worst cell rel {rel:.2e} (limit 1e-3)")
        if not (rel <= 1e-3 and mean_rel <= 1e-4):
            raise AssertionError(f"{label}: {name} on the card disagrees with the CPU run")
    c = cpu.ionized_box.cumulative_recombinations
    g = gpu.ionized_box.cumulative_recombinations
    if c is not None:
        c, g = c.double(), g.cpu().double()
        mean_rel = abs(g.mean().item() - c.mean().item()) / abs(c.mean().item())
        share = ((c - g).abs() > 1e-3 * c.max()).double().mean().item()
        print(f"[small] {label} N_rec: mean {g.mean().item():.6g} card vs {c.mean().item():.6g} CPU "
              f"(rel {mean_rel:.2e}, limit 5e-3), max {c.max().item():.4g}, share of cells off by "
              f"> 1e-3 max {share:.2e} (limit 1e-3)")
        if not (mean_rel <= 5e-3 and share <= 1e-3):
            raise AssertionError(f"{label}: N_rec on the card disagrees with the CPU run")


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


def evolving_small_phase():
    """The golden-size evolving coeval with a spin temperature and
    inhomogeneous recombinations (the golden "ts" and "inhomo" options
    together) on the card against the CPU."""
    _card_vs_cpu_coeval(
        "USE_TS_FLUCT+INHOMOGENEOUS", nodes=True,
        USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=20.0)


def _check_fields(z, lo, *structs):
    """Every grid of the structs has the lowres shape (the minihalo Nion
    stacks one such grid a radius), lies on the card and is finite."""
    import torch

    for struct in structs:
        if struct is None:
            continue
        for name, v in vars(struct).items():
            if isinstance(v, torch.Tensor):
                if tuple(v.shape[-3:]) != lo or v.ndim not in (3, 4) or not v.is_cuda:
                    raise AssertionError(f"{name} at z={z}: {tuple(v.shape)} on {v.device}")
                if not bool(torch.isfinite(v).all()):
                    raise AssertionError(f"{name} at z={z} is not finite")


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
        k["launches_by_path"] = {"simple": launches[k["name"]]}
        if launches[k["name"]] < 1:
            raise AssertionError(f"the main path never launched {k['name']}")
    if launches["cic_deposit_swept"] != len(MAIN_REDSHIFTS):
        raise AssertionError(f"expected {len(MAIN_REDSHIFTS)} deposit launches, got {launches}")

    lo = inputs.simulation_options.lowres_shape
    xh = {}
    for cv in coevals:
        _check_fields(cv.redshift, lo, cv.perturbed_field, cv.ionized_box, cv.brightness_temperature)
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
    the profiler recorded no device activity.  A one-element fill runs first
    inside the profile and is left out of the sums: the tracer may drop the
    first device events of a window (seen once: a perturb whose deposit
    kernel was missing from the trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        _sync_time(fn)
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )[1:]
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


# ZPRIME_STEP_FACTOR=1.04 (37 nodes) cuts the depth of this scroll, whose
# width phases 9 and 10 drive at 256^3 down 92 nodes of 1.02
SCROLL_OPTIONS = dict(
    USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS", CELL_RECOMB=False, R_BUBBLE_MAX=50.0,
    N_STEP_TS=40, R_MAX_TS=500.0, ZPRIME_STEP_FACTOR=1.04,
)
SCROLL_Z_END = 8.0


def _scroll_inputs():
    import py21cmfast_torch as p21

    return p21.InputParameters.from_template(
        MAIN_TEMPLATE, random_seed=SEED
    ).evolve_input_structs(**SCROLL_OPTIONS).with_logspaced_redshifts(SCROLL_Z_END)


def scroll_phase(kernels):
    """The evolving coeval at full width: generate_coeval yields every node of
    the ladder down to z=8; launch counts zeroed just before.  Returns the
    inputs, the ICs and, for three sample nodes, what the node was computed
    from (for the per-stage pass)."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.drivers.coeval import _slim_chain_ion
    from py21cmfast_torch.models import spintemp
    from py21cmfast_torch.ops import deposit

    wrappers = {"cic_deposit_swept": deposit.cic_deposit_swept}
    inputs = _scroll_inputs()
    so = inputs.simulation_options
    nodes = list(inputs.node_redshifts)
    evolving = [i for i, z in enumerate(nodes) if z < so.Z_HEAT_MAX and i > 0]
    sample_at = {evolving[0], evolving[len(evolving) // 2], len(nodes) - 1}
    print(f"[scroll] {MAIN_TEMPLATE} + {SCROLL_OPTIONS}, ZPRIME_STEP_FACTOR "
          f"{so.ZPRIME_STEP_FACTOR}, Z_HEAT_MAX {so.Z_HEAT_MAX}: {len(nodes)} nodes "
          f"{nodes[0]:.3f} -> {nodes[-1]:.3f}")

    # host seconds inside each Ts step (no synchronisation added)
    ts_host = []
    compute_ts = spintemp.compute_spin_temperature

    def timed_ts(*a, **kw):
        t0 = time.perf_counter()
        out = compute_ts(*a, **kw)
        ts_host.append(time.perf_counter() - t0)
        return out

    stats = spintemp._SFRD_PREFETCH["stats"]
    stats.update(build_s=0.0, wait_s=0.0)
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    spintemp.compute_spin_temperature = timed_ts
    seconds, means, samples, prev, ics = [], [], {}, None, None
    try:
        torch.cuda.synchronize()
        t_start = t0 = time.perf_counter()
        for i, cv in enumerate(p21.generate_coeval(inputs)):
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if cv.redshift != nodes[i]:
                raise AssertionError(f"node {i}: yielded z={cv.redshift}, expected {nodes[i]}")
            ics = cv.initial_conditions
            _check_fields(cv.redshift, so.lowres_shape, cv.perturbed_field, cv.spin_temp,
                          cv.ionized_box, cv.brightness_temperature)
            ts = cv.spin_temp
            means.append(torch.stack([
                cv.neutral_fraction.double().mean(), cv.brightness_temp.double().mean(),
                ts.kinetic_temp_neutral.double().mean(), ts.spin_temperature.double().mean(),
                ts.xray_ionised_fraction.double().mean(),
                (cv.ionized_box.cumulative_recombinations.double().mean()
                 if cv.ionized_box.cumulative_recombinations is not None
                 else torch.zeros((), dtype=torch.float64, device="cuda")),
            ]).tolist())
            if i in sample_at:
                samples[i] = dict(z=cv.redshift, pf=cv.perturbed_field, prev_ts=prev[0],
                                  prev_ion=prev[1], prev_z=prev[2], ts=ts, ion=cv.ionized_box)
            prev = (ts, _slim_chain_ion(cv.ionized_box, keep_xh=False), cv.redshift)
            t0 = time.perf_counter()
        total = time.perf_counter() - t_start
    finally:
        spintemp.compute_spin_temperature = compute_ts
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    if len(seconds) != len(nodes):
        raise AssertionError(f"{len(seconds)} coevals from {len(nodes)} nodes")
    for k in kernels:
        k["launches_by_path"]["scroll"] = launches[k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
        if launches[k["name"]] < 1:
            raise AssertionError(f"the scroll never launched {k['name']}")
    if launches["cic_deposit_swept"] != len(nodes):
        raise AssertionError(f"expected {len(nodes)} deposit launches in the scroll, got {launches}")

    # seconds[0] holds the ICs and everything built at first use
    later = np.array(seconds[1:])
    hidden = stats["build_s"] - stats["wait_s"]
    ts_total = float(np.sum(ts_host))
    print(f"[scroll] {len(nodes)} nodes in {total:.2f} s on the card: first node (with the ICs) "
          f"{seconds[0]:.3f} s, then median {np.median(later):.4f} s a node "
          f"(min {later.min():.4f}, max {later.max():.4f}); launches {launches}; peak memory "
          f"{peak:.3f} GiB")
    print(f"[scroll] Ts step, host seconds inside the call: total {ts_total:.2f} s, median "
          f"{np.median(ts_host):.4f} s a node; the prefetch thread built SFRD tables for "
          f"{stats['build_s']:.2f} s and nodes waited {stats['wait_s']:.2f} s for them: "
          f"{hidden:.2f} s hidden, {100 * hidden / (ts_total + hidden):.1f}% of the Ts wall "
          f"there would be without it")
    for i in sorted({0, *sample_at, len(nodes) // 4, 3 * len(nodes) // 4}):
        xh, tb, tk, tsp, xe, nrec = means[i]
        print(f"[scroll] node {i:2d} z={nodes[i]:7.3f}: {seconds[i]:.4f} s, <xH> {xh:.6f}, <Tb> "
              f"{tb:.4f} mK, <Tk> {tk:.4f} K, <Ts> {tsp:.4f} K, <x_e> {xe:.3e}, <N_rec> {nrec:.3e}")
    xh, tb, tk, tsp, xe, nrec = means[-1]
    tk_all = np.array([m[2] for m in means])
    i_min = int(tk_all.argmin())
    print(f"[scroll] z={nodes[-1]}: <xH> {xh:.6f}, <Tb> {tb:.5f} mK, <Tk> {tk:.4f} K, <Ts> "
          f"{tsp:.4f} K; <Tk> was least at node {i_min} z={nodes[i_min]:.3f}: {tk_all[i_min]:.4f} K")
    if not 0.0 < xh < 1.0:
        raise AssertionError(f"<xH> at z={nodes[-1]} is {xh}")
    if not (0 < i_min < len(nodes) - 1 and tk > 1.5 * tk_all[i_min]):
        raise AssertionError("Tk has not passed its minimum (no heating turn-around) by the last node")
    if not nrec > 0:
        raise AssertionError("no recombinations were accumulated")
    return inputs, ics, [samples[i] for i in sorted(samples)]


def _fixed_halos_stages(inputs, ics, s, z):
    """The L-INTEGRAL stages of one node: the HaloBox whole and by its parts
    (host tables, gathers, displacement scatter; the parts are not summed
    into the node), the XraySourceBox from the scroll's history, the Ts step
    that reads it, as (name, prepare, fn, summed)."""
    from py21cmfast_torch.models import halobox as hbm
    from py21cmfast_torch.models import spintemp, xray_source
    from py21cmfast_torch.models.hmf import set_scaling_constants
    from py21cmfast_torch.models.perturb import _displacement_factors

    mini = inputs.astro_options.USE_MINI_HALOS
    so = inputs.simulation_options
    parts = {}

    def mt_grids():
        if not mini:
            return None, None
        return hbm._mcrit_grids(z, inputs, set_scaling_constants(z, inputs), s["prev_ts"],
                                s["prev_ion"], ics.lowres_vcb)

    def halobox_whole():
        mt_a, mt_m = mt_grids()
        return hbm.compute_fixed_halo_grid(z, inputs, ics.lowres_density, mt_a_grid=mt_a,
                                           mt_m_grid=mt_m, ics=ics)

    def prep_gather():
        parts["h"], parts["mt"] = hbm.fixed_grid_tables(z, inputs), mt_grids()

    def prep_scatter():
        hb = s["halobox"]
        props = [hb.n_ion, hb.halo_sfr, hb.whalo_sfr, hb.halo_xray, hb.halo_stars]
        props += [hb.halo_sfr_mini, hb.halo_stars_mini] if mini else []
        _, _, fac_za, fac_2lpt = _displacement_factors(inputs, z)
        parts["scatter"] = (
            props, (ics.vx, ics.vy, ics.vz), (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT),
            float(np.float32(fac_za)), float(np.float32(fac_2lpt)),
            float(np.float32(so.HII_DIM / so.box_len)))

    def source_box():
        return xray_source.compute_xray_source_field(
            z, inputs, s["history"], previous_ionized_box=s["prev_ion"])

    def prep_ts():
        parts["source"] = source_box()

    def ts_step():
        return spintemp.compute_spin_temperature(
            z, inputs, s["pf"], prev_state=s["prev_ts"], prev_redshift=s["prev_z"],
            initial_conditions=ics, source_box=parts["source"], previous_ionized_box=s["prev_ion"])

    stages = [
        ("HaloBox", None, halobox_whole, True),
        ("HaloBox host tables", None, lambda: hbm.fixed_grid_tables(z, inputs), False),
        ("HaloBox gathers", prep_gather, lambda: hbm._gather_cells(
            parts["h"], ics.lowres_density, *parts["mt"], one_plus_delta=False), False),
        ("HaloBox displacement scatter", prep_scatter,
         lambda: hbm._displace_grids(*parts["scatter"]), False),
        ("XraySourceBox", None, source_box, True),
        ("Ts", prep_ts, ts_step, True),
    ]
    return stages, parts


def _node_stages(inputs, ics, s, tag):
    """Warm, synchronised per-stage times at one node of a scroll, each stage
    recomputed from the state the scroll handed it, then its device-busy
    time from a second, profiled pass.  The Ts step of the density-sourced
    models is taken twice: building its SFRD tables itself, and with them
    prefetched (the build is then outside the timed call); with L-INTEGRAL
    sources the HaloBox and XraySourceBox stages come first (see
    `_fixed_halos_stages`).  Returns the stages as (name, prepare, fn,
    summed into the node)."""
    import py21cmfast_torch as p21
    from py21cmfast_torch.models import spintemp

    def prefetch_now(z):
        spintemp.prefetch_sfrd_tables(z, inputs)
        for fut in list(spintemp._SFRD_PREFETCH["futs"].values()):
            fut.result()

    z = s["z"]
    lagrangian = inputs.matter_options.SOURCE_MODEL == "L-INTEGRAL"
    parts = {}

    def ts_step():
        return spintemp.compute_spin_temperature(
            z, inputs, s["pf"], prev_state=s["prev_ts"], prev_redshift=s["prev_z"],
            initial_conditions=ics, previous_ionized_box=s["prev_ion"])

    stages = [("perturb", None, lambda: p21.perturb_field(z, inputs, ics), True)]
    if lagrangian:
        lagr_stages, parts = _fixed_halos_stages(inputs, ics, s, z)
        stages += lagr_stages
    else:
        stages += [
            ("Ts (builds its tables)", None, ts_step, False),
            ("Ts (tables prefetched)", lambda: prefetch_now(z), ts_step, True),
        ]
    stages += [
        ("ionize", None, lambda: p21.compute_ionization_field(
            z, inputs, s["pf"], previous_ionized_box=s["prev_ion"], spin_temp=s["ts"],
            prev_redshift=s["prev_z"], previous_perturbed_field=s.get("prev_pf"),
            vcb_box=ics.lowres_vcb, halobox=s.get("halobox")), True),
        ("Tb", None, lambda: p21.brightness_temperature(
            inputs, s["ion"], s["pf"], spin_temp=s["ts"]), True),
    ]
    walls, busies = [], []
    for name, prepare, fn, summed in stages:
        if prepare:
            prepare()
        _, wall = _sync_time(fn)
        if prepare:
            prepare()
        busy = _device_busy_ms(fn)
        busy_txt = (
            "device busy not measured (the profiler saw no device activity)" if busy is None
            else f"device busy {busy[0]:.3f} ms ({100 * busy[0] / (wall * 1e3):.1f}% of the "
                 f"unprofiled wall), top kernels {busy[1]}"
        )
        print(f"[{tag}] z={z:.3f} {name}: {wall * 1e3:.2f} ms wall; {busy_txt}")
        if summed:
            walls.append(wall * 1e3)
            busies.append(0.0 if busy is None else busy[0])
    summed = ", ".join(name for name, _, _, on in stages if on)
    print(f"[{tag}] z={z:.3f} node of {summed}: {sum(walls):.2f} ms wall, {sum(busies):.3f} ms "
          f"device busy ({100 * sum(busies) / sum(walls):.1f}%)")
    if lagrangian:
        n_props = len(parts["scatter"][0])
        ms = _event_median_ms(lambda: stages[4][2](), reps=10)
        print(f"[{tag}] z={z:.3f} _displace_grids ({n_props} property grids of "
              f"{inputs.simulation_options.lowres_shape}, 8 CIC corners each): {ms:.3f} ms a call "
              f"(CUDA events, median of 10)")
        parts.clear()
    return stages


def scroll_stage_phase(inputs, ics, samples):
    """Per-stage times at three nodes of the scroll, then where the host's
    time goes in the last node's Ts and ionize steps (cProfile)."""
    import cProfile
    import pstats

    for s in samples:
        stages = _node_stages(inputs, ics, s, "scroll-stages")
    z = samples[-1]["z"]
    for name, prepare, fn, _ in stages[2:4]:
        if prepare:
            prepare()
        prof = cProfile.Profile()
        _sync_time(lambda: prof.runcall(fn))
        st = pstats.Stats(prof)
        total = st.total_tt
        top = sorted(st.stats.items(), key=lambda kv: -kv[1][3])[:60]
        ours = [(f"{k[0].rsplit('/', 1)[-1]}:{k[2]}", round(1e3 * v[3], 1)) for k, v in top
                if "py21cmfast_torch" in k[0]][:8]
        print(f"[scroll-host] z={z:.3f} {name}: {1e3 * total:.1f} ms under cProfile; cumulative "
              f"ms by function of the package: {ours}")


def _tracked_lightconer(inputs):
    """The lightconer generate_lightcone would make by default, with a mask
    of the slices its make_lightcone_slices has returned."""
    import py21cmfast_torch as p21

    nodes = np.asarray(inputs.node_redshifts)
    lcr = p21.RectilinearLightconer.with_equal_cdist_slices(
        float(nodes.min()), float(nodes.max()), inputs,
        quantities=("brightness_temp",) + (("tau_21",) if inputs.astro_options.USE_TS_FLUCT else ()),
    )
    written = np.zeros(lcr.n_slices, bool)
    make = lcr.make_lightcone_slices

    def tracked(*a, **kw):
        idx, vals = make(*a, **kw)
        if idx is not None:
            written[idx.cpu().numpy()] = True
        return idx, vals

    lcr.make_lightcone_slices = tracked
    return lcr, written


def _check_written(written, lcr, inputs, label):
    """Every slice is written but one on the top node's distance exactly (the
    JAX package's rule selects d_low <= d < d_high)."""
    d_top = inputs.cosmology.comoving_distance(float(np.max(inputs.node_redshifts)))
    missing = np.where(~written)[0]
    if not all(i == lcr.n_slices - 1 and lcr.lc_distances[i] >= d_top for i in missing):
        raise AssertionError(f"{label}: slices {missing[:10]} of {lcr.n_slices} were never written")
    return len(missing)


GOLDEN_LIGHTCONES = {
    # tests/produce_golden_data.py:43,50-53: saturated Ts, nodes z=14.6 -> 9
    "golden lightcone": (dict(), (9.0, 14.0)),
    # the tau_21 branch of the velocity-gradient correction, 5 nodes
    "USE_TS_FLUCT+INHOMOGENEOUS lightcone": (
        dict(USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=20.0), (10.5, 25.0)),
}


def _card_vs_cpu_cones(label, inputs, runs):
    """Cones and global quantities of one lightcone on the card against the
    CPU.  `runs` maps "cpu" and "cuda" to (LightCone, written mask,
    unwritten boundary slices)."""
    (cpu, w_cpu, miss), (gpu, w_gpu, _) = runs["cpu"], runs["cuda"]
    if not (w_cpu == w_gpu).all():
        raise AssertionError(f"{label}: the card and the CPU wrote different slices")
    ok = True
    for q, c in cpu.lightcones.items():
        g = gpu.lightcones[q].cpu().double()
        c = c.double()
        scale = c.abs().max().item()
        diff = (g - c).abs()
        share = (diff > 1e-4 * scale).double().mean().item()
        finite = bool(gpu.lightcones[q].isfinite().all())
        print(f"[lightcone-small] {label} {q} {tuple(c.shape)}: max |card - CPU| "
              f"{diff.max().item():.3e} of max {scale:.4g}, share of cells off by > 1e-4 max "
              f"{share:.2e} (limit 1e-3), finite {finite}")
        ok &= share <= 1e-3 and finite
    for q, c in cpu.global_quantities.items():
        g = gpu.global_quantities[q]
        lim = 1e-3 if q == "neutral_fraction" else 1e-3 * cpu.lightcones["brightness_temp"].abs().max().item()
        err = np.abs(g - c).max()
        print(f"[lightcone-small] {label} global {q} per node: card {np.round(g, 6).tolist()}, "
              f"max |card - CPU| {err:.3e} (limit {lim:.3e})")
        ok &= err <= lim
    print(f"[lightcone-small] {label}: {len(inputs.node_redshifts)} nodes, "
          f"{cpu.lightconer.n_slices} slices, {miss} boundary slice(s) unwritten in both runs")
    if not ok:
        raise AssertionError(f"the golden-size {label} on the card disagrees with the CPU run")


def lightcone_small_phase():
    """Golden-size lightcones (dvdr and RSDs on) on the card against the same
    lightcones on the CPU, from one hires density.  Per cell of each cone:
    |card - CPU| <= 1e-4 max|cone| for all but at most 1e-3 of the cells
    (xH is thresholded, so a cell may flip on float32 rounding, and the RSD
    scatter adds in a run-dependent order on the card); per node: the global
    xH within 1e-3 and the mean Tb within 1e-3 max|Tb|; the same slices
    written in both runs, all but a boundary one."""
    import py21cmfast_torch as p21

    for label, (over, (z_lo, z_hi)) in GOLDEN_LIGHTCONES.items():
        inputs = p21.InputParameters(random_seed=SEED).evolve_input_structs(
            **GOLDEN_SIZE, **over).with_logspaced_redshifts(z_lo, z_hi)
        ics_cpu = p21.compute_initial_conditions(inputs, device="cpu")
        ics_gpu = p21.compute_initial_conditions(
            inputs, initial_density=ics_cpu.hires_density.numpy())
        runs = {}
        for dev, ics in (("cpu", ics_cpu), ("cuda", ics_gpu)):
            lcr, written = _tracked_lightconer(inputs)
            lc = p21.run_lightcone(inputs, lightconer=lcr, initial_conditions=ics, device=dev)
            runs[dev] = (lc, written, _check_written(written, lcr, inputs, f"{label} on {dev}"))
        _card_vs_cpu_cones(label, inputs, runs)


# The Munoz et al. EOS21 parametrization, templates/Munoz21.toml.  The
# manifest also lists "Munoz21" as an alias of "minihalos" and the lookup
# takes that entry first, so the template is asked for by its alias "EOS21".
MINIHALO_TEMPLATE = "EOS21"
# per-node fields of phase 4e, by the struct that holds them
MINIHALO_FIELDS = {
    "spin_temp": ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction", "J_21_LW"),
    "ionized_box": ("neutral_fraction", "unnormalised_nion", "unnormalised_nion_mini"),
    "brightness_temperature": ("brightness_temp",),
}


def _minihalo_node(cv):
    """A node's phase-4e fields as float64 host tensors, with its turnover means."""
    fields = {}
    for struct, names in MINIHALO_FIELDS.items():
        for name in names:
            v = getattr(getattr(cv, struct), name)
            fields[name] = None if v is None else v.cpu().double()
    ion = cv.ionized_box
    return fields, float(ion.log10_Mturnover_ave), float(ion.log10_Mturnover_MINI_ave)


def minihalo_small_phase():
    """The golden-size Munoz21 lightcone on the card against the CPU, both from
    one hires density.  The v_cb box: max-abs <= 1e-5 of its maximum.  Per
    node: Ts, Tk, x_e and J_21_LW every cell within 1e-3 of its own value and
    the mean within 1e-4 (as phase 4c); xH at most 1e-3 of the cells off by
    1e-3; Tb and each Nion stack at most 1e-3 of the cells off by 1e-4 of the
    maximum (a cell's first crossing sets its Gamma12, which feeds the next
    node's turnover masses); the log10 turnover means within 1e-3.  Then the
    cones and global quantities as in phase 4d."""
    import py21cmfast_torch as p21

    label = "Munoz21 lightcone"
    inputs = p21.InputParameters.from_template(
        MINIHALO_TEMPLATE, random_seed=SEED
    ).evolve_input_structs(**GOLDEN_SIZE, R_BUBBLE_MAX=12.0).with_logspaced_redshifts(10.5, 25.0)
    ao, mo = inputs.astro_options, inputs.matter_options
    if not (ao.USE_MINI_HALOS and mo.V_CB_MODEL == "FLUCTS" and ao.HII_FILTER == "SHARP-K"):
        raise AssertionError(f"{MINIHALO_TEMPLATE} is not the Munoz21 template")
    ics_cpu = p21.compute_initial_conditions(inputs, device="cpu")
    ics_gpu = p21.compute_initial_conditions(inputs, initial_density=ics_cpu.hires_density.numpy())
    c, g = ics_cpu.lowres_vcb.double(), ics_gpu.lowres_vcb.cpu().double()
    err, scale = (c - g).abs().max().item(), c.abs().max().item()
    print(f"[minihalo-small] {label} v_cb box {tuple(c.shape)}: mean {g.mean().item():.4f} km/s card "
          f"vs {c.mean().item():.4f} CPU, max-abs {err:.3e} of max {scale:.4g} (limit 1e-5 max)")
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{label}: the v_cb box on the card disagrees with the CPU")

    runs, nodes = {}, {}
    for dev, ics in (("cpu", ics_cpu), ("cuda", ics_gpu)):
        lcr, written = _tracked_lightconer(inputs)
        nodes[dev] = []
        for z, cv, lc in p21.generate_lightcone(
                inputs, lightconer=lcr, initial_conditions=ics, device=dev):
            if z is not None:
                nodes[dev].append(_minihalo_node(cv))
        runs[dev] = (lc, written, _check_written(written, lcr, inputs, f"{label} on {dev}"))

    ok = True
    for z, (c, mt_c, mtm_c), (g, mt_g, mtm_g) in zip(inputs.node_redshifts, nodes["cpu"], nodes["cuda"]):
        worst = {}
        for name in MINIHALO_FIELDS["spin_temp"]:
            cc, gg = c[name], g[name]
            rel = ((gg - cc).abs() / cc.abs().clamp_min(1e-30)).max().item()
            mean_rel = abs(gg.mean().item() - cc.mean().item()) / max(abs(cc.mean().item()), 1e-30)
            worst[name] = rel
            ok &= rel <= 1e-3 and mean_rel <= 1e-4
        flipped = ((g["neutral_fraction"] - c["neutral_fraction"]).abs() > 1e-3).double().mean().item()
        ok &= flipped <= 1e-3
        shares = {}
        for name in ("brightness_temp", "unnormalised_nion", "unnormalised_nion_mini"):
            if (c[name] is None) != (g[name] is None):
                raise AssertionError(f"{label} z={z:.3f}: {name} on one device only")
            if c[name] is None:
                continue
            diff, scale = (g[name] - c[name]).abs(), c[name].abs().max().item()
            shares[name] = ((diff > 1e-4 * scale).double().mean().item(), diff.max().item() / scale)
            ok &= shares[name][0] <= 1e-3
        ok &= abs(mt_g - mt_c) <= 1e-3 and abs(mtm_g - mtm_c) <= 1e-3
        print(f"[minihalo-small] {label} z={z:.3f}: <J_21_LW> {g['J_21_LW'].mean().item():.5g} card vs "
              f"{c['J_21_LW'].mean().item():.5g} CPU, log10 Mturn ACG {mt_g:.6f} vs {mt_c:.6f}, MCG "
              f"{mtm_g:.6f} vs {mtm_c:.6f}; worst cell rel {{{', '.join(f'{k}: {v:.2e}' for k, v in worst.items())}}} "
              f"(limit 1e-3); xH flipped share {flipped:.2e}; (share off by > 1e-4 max, max err / max) "
              f"{{{', '.join(f'{k}: ({v[0]:.2e}, {v[1]:.2e})' for k, v in shares.items())}}}")
    if not ok:
        raise AssertionError(f"the golden-size {label}'s nodes on the card disagree with the CPU run")
    if nodes["cuda"][-1][0]["unnormalised_nion"] is None:
        raise AssertionError(f"{label}: the last node carries no Nion stacks")
    _card_vs_cpu_cones(label, inputs, runs)


FIXED_HALOS_TEMPLATE = "fixed-halos"
# phase 4f's golden-size L-INTEGRAL lightcones, by what they add to the template
FIXED_HALOS_SMALL = {
    "fixed-halos lightcone": dict(),
    "L-INTEGRAL+minihalos lightcone": dict(USE_MINI_HALOS=True),
    "L-INTEGRAL+minihalos+Lya-multiple-scattering lightcone": dict(
        USE_MINI_HALOS=True, LYA_MULTIPLE_SCATTERING=True),
}
HALOBOX_FIELDS = ("n_ion", "halo_sfr", "whalo_sfr", "halo_xray", "halo_stars", "halo_sfr_mini",
                  "halo_stars_mini")
SOURCE_FIELDS = ("filtered_sfr", "filtered_xray", "filtered_sfr_mini", "filtered_sfr_lw",
                 "filtered_sfr_mini_lw")


def _host_fields(struct, names):
    return {n: None if getattr(struct, n) is None else getattr(struct, n).cpu().double()
            for n in names}


def fixed_halos_small_phase():
    """Golden-size L-INTEGRAL lightcones on the card against the CPU, from one
    hires density: the fixed-halos template, with minihalos, and with
    minihalos and the Lya multiple-scattering window (straight-line LW
    shells).  Per node: the HaloBox grids and every XraySourceBox stack at
    most 1e-3 of the cells off by 1e-4 of the maximum (of the stack's shell);
    Ts, Tk, x_e, J_21_LW, xH and Tb as in phase 4e; then the cones as in 4d."""
    import py21cmfast_torch as p21
    from py21cmfast_torch.models import xray_source

    size = {k: v for k, v in GOLDEN_SIZE.items() if k != "SOURCE_MODEL"}
    source_field = xray_source.compute_xray_source_field
    for label, over in FIXED_HALOS_SMALL.items():
        inputs = p21.InputParameters.from_template(
            FIXED_HALOS_TEMPLATE, random_seed=SEED
        ).evolve_input_structs(**size, R_BUBBLE_MAX=12.0, **over).with_logspaced_redshifts(10.5, 25.0)
        if inputs.matter_options.SOURCE_MODEL != "L-INTEGRAL":
            raise AssertionError(f"{FIXED_HALOS_TEMPLATE} does not use L-INTEGRAL sources")
        ics_cpu = p21.compute_initial_conditions(inputs, device="cpu")
        ics_gpu = p21.compute_initial_conditions(inputs, initial_density=ics_cpu.hires_density.numpy())
        runs, nodes = {}, {}
        for dev, ics in (("cpu", ics_cpu), ("cuda", ics_gpu)):
            sources = {}

            def recorded(z, *a, sources=sources, **kw):
                out = source_field(z, *a, **kw)
                sources[z] = _host_fields(out, SOURCE_FIELDS)
                return out

            lcr, written = _tracked_lightconer(inputs)
            nodes[dev] = []
            xray_source.compute_xray_source_field = recorded
            try:
                for z, cv, lc in p21.generate_lightcone(
                        inputs, lightconer=lcr, initial_conditions=ics, device=dev):
                    if z is not None:
                        fields, _, _ = _minihalo_node(cv)
                        fields.update(_host_fields(cv.halobox, HALOBOX_FIELDS))
                        nodes[dev].append((z, fields))
            finally:
                xray_source.compute_xray_source_field = source_field
            for z, fields in nodes[dev]:
                fields["source"] = sources.get(z)
            runs[dev] = (lc, written, _check_written(written, lcr, inputs, f"{label} on {dev}"))

        ok = True
        n_sources = 0
        for (z, c), (_, g) in zip(nodes["cpu"], nodes["cuda"]):
            worst = {}
            for name in MINIHALO_FIELDS["spin_temp"]:
                cc, gg = c[name], g[name]
                if (cc is None) != (gg is None):
                    raise AssertionError(f"{label} z={z:.3f}: {name} on one device only")
                if cc is None:
                    continue
                rel = ((gg - cc).abs() / cc.abs().clamp_min(1e-30)).max().item()
                mean_rel = abs(gg.mean().item() - cc.mean().item()) / max(abs(cc.mean().item()), 1e-30)
                worst[name] = rel
                ok &= rel <= 1e-3 and mean_rel <= 1e-4
            flipped = ((g["neutral_fraction"] - c["neutral_fraction"]).abs() > 1e-3).double().mean().item()
            ok &= flipped <= 1e-3
            shares = {}
            grids = [(n, c[n], g[n]) for n in ("brightness_temp",) + HALOBOX_FIELDS]
            if (c["source"] is None) != (g["source"] is None):
                raise AssertionError(f"{label} z={z:.3f}: an XraySourceBox on one device only")
            if c["source"] is not None:
                n_sources += 1
                grids += [(n, c["source"][n], g["source"][n]) for n in SOURCE_FIELDS]
            for name, cc, gg in grids:
                if (cc is None) != (gg is None):
                    raise AssertionError(f"{label} z={z:.3f}: {name} on one device only")
                if cc is None:
                    continue
                # a stack is held shell by shell, against the shell's maximum
                scale = (cc.abs().amax(dim=(-3, -2, -1), keepdim=True) if cc.ndim == 4
                         else cc.abs().max())
                diff = (gg - cc).abs()
                shares[name] = ((diff > 1e-4 * scale).double().mean().item(),
                                (diff / scale.clamp_min(1e-30)).max().item())
                ok &= shares[name][0] <= 1e-3
            print(f"[fixed-halos-small] {label} z={z:.3f}: worst cell rel "
                  f"{{{', '.join(f'{k}: {v:.2e}' for k, v in worst.items())}}} (limit 1e-3); xH "
                  f"flipped share {flipped:.2e}; (share off by > 1e-4 max, max err / max) "
                  f"{{{', '.join(f'{k}: ({v[0]:.2e}, {v[1]:.2e})' for k, v in shares.items())}}}")
        if not ok:
            raise AssertionError(f"the golden-size {label}'s nodes on the card disagree with the CPU run")
        if n_sources != len(inputs.node_redshifts) - 1:
            raise AssertionError(f"{label}: {n_sources} XraySourceBoxes in {len(nodes['cpu'])} nodes")
        if over.get("LYA_MULTIPLE_SCATTERING") and nodes["cuda"][-1][1]["source"]["filtered_sfr_lw"] is None:
            raise AssertionError(f"{label}: no straight-line LW shells")
        _card_vs_cpu_cones(label, inputs, runs)


HEADLINE_SEED = 3
HEADLINE_Z_END = 5.0
HEADLINE_BOX = dict(HII_DIM=256, DIM=768, BOX_LEN=384.0, Z_HEAT_MAX=35.0, ZPRIME_STEP_FACTOR=1.02,
                    MINIMIZE_MEMORY=True)


def _headline_inputs():
    """The repo's headline lightcone (bench.py:73-91): 256^3 at 1.5 Mpc cells
    with a 768^3 hires grid, E-INTEGRAL sources, USE_TS_FLUCT, inhomogeneous
    recombinations, 92 nodes from z=35.37 to z=5."""
    import py21cmfast_torch as p21

    return p21.InputParameters(random_seed=HEADLINE_SEED).evolve_input_structs(
        SOURCE_MODEL="E-INTEGRAL", USE_TS_FLUCT=True, RECOMB_MODEL="inhomogeneous",
        R_BUBBLE_MAX=50.0, USE_EXP_FILTER=False, CELL_RECOMB=False, **HEADLINE_BOX,
    ).with_logspaced_redshifts(HEADLINE_Z_END)


def _minihalo_headline_inputs():
    """The Munoz21 template (minihalos, LW feedback, v_cb FLUCTS, USE_TS_FLUCT,
    inhomogeneous recombinations, SHARP-K, R_BUBBLE_MAX=50) at the headline's
    box and node ladder."""
    import py21cmfast_torch as p21

    return p21.InputParameters.from_template(
        MINIHALO_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**HEADLINE_BOX).with_logspaced_redshifts(HEADLINE_Z_END)


def _fixed_halos_headline_inputs():
    """The fixed-halos template (L-INTEGRAL, USE_EXP_FILTER, CELL_RECOMB,
    USE_TS_FLUCT, inhomogeneous recombinations, R_BUBBLE_MAX=50) at the
    headline's box and node ladder."""
    import py21cmfast_torch as p21

    return p21.InputParameters.from_template(
        FIXED_HALOS_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**HEADLINE_BOX).with_logspaced_redshifts(HEADLINE_Z_END)


def _moved(struct, device):
    """A copy of an output struct with its tensors on `device`."""
    import dataclasses

    import torch

    if struct is None:
        return None
    return dataclasses.replace(struct, **{
        k: v.to(device) for k, v in vars(struct).items() if isinstance(v, torch.Tensor)})


def _without_stacks(ion):
    """The IonizedBox without its minihalo Nion stacks."""
    import dataclasses

    return dataclasses.replace(ion, unnormalised_nion=None, unnormalised_nion_mini=None)


def lightcone_phase(kernels, inputs, ics, ics_s, tag, path, sample_z):
    """A full-size lightcone through generate_lightcone with dvdr and RSDs,
    from ICs computed before (as bench.py hands them in); launch counts zeroed
    just before and read just after (one deposit launch per node).  Then the
    finalization's device-busy times and the stages of the nodes nearest each
    of `sample_z`, recomputed from the state the scroll handed them; that
    state is kept on the host meanwhile, so that it adds nothing to the run's
    peak memory."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch import rsds
    from py21cmfast_torch.drivers.coeval import _slim_chain_ion, _slim_chain_pf
    from py21cmfast_torch.models import xray_source
    from py21cmfast_torch.ops import deposit

    so = inputs.simulation_options
    mini = inputs.astro_options.USE_MINI_HALOS
    lagrangian = inputs.matter_options.SOURCE_MODEL == "L-INTEGRAL"
    nodes = list(inputs.node_redshifts)
    sample_at = sorted({int(np.argmin(np.abs(np.asarray(nodes) - z))) for z in sample_z})
    lcr, written = _tracked_lightconer(inputs)
    print(f"[{tag}] HII_DIM={so.HII_DIM} DIM={so.DIM} BOX_LEN={so.BOX_LEN}, seed "
          f"{inputs.random_seed}: {len(nodes)} nodes {nodes[0]:.3f} -> {nodes[-1]:.3f}, "
          f"{lcr.n_slices} slices; ICs {ics_s:.3f} s (first call)")

    # the finalization's two steps, timed where the driver calls them; their
    # inputs are kept for the profiled pass
    final = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            final[name] = (time.perf_counter() - t0, fn, a, kw)
            return out
        return run

    steps = {"dvdr": "include_dvdr_in_tau21", "RSDs": "apply_rsds"}
    originals = {name: getattr(rsds, attr) for name, attr in steps.items()}
    # L-INTEGRAL: generate_coeval's HaloBox history as the sampled nodes'
    # source boxes read it (grids the scroll holds anyway, kept for the stages)
    histories = {}
    source_field = xray_source.compute_xray_source_field
    sample_zs = {nodes[i] for i in sample_at}

    def recorded_source(z, inputs_, halobox_nodes, *a, **kw):
        if z in sample_zs:
            histories[z] = list(halobox_nodes)
        return source_field(z, inputs_, halobox_nodes, *a, **kw)

    wrappers = {"cic_deposit_swept": deposit.cic_deposit_swept}
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    for name, attr in steps.items():
        setattr(rsds, attr, timed(name, originals[name]))
    xray_source.compute_xray_source_field = recorded_source
    seconds, xh, mini_means, samples, prev, lc = [], [], [], {}, None, None
    try:
        torch.cuda.synchronize()
        t_start = t0 = time.perf_counter()
        for i, (z, cv, lc) in enumerate(p21.generate_lightcone(
                inputs, lightconer=lcr, initial_conditions=ics,
                include_dvdr_in_tau21=True, apply_rsds=True)):
            torch.cuda.synchronize()
            if z is None:
                t_final = time.perf_counter() - t0
                break
            seconds.append(time.perf_counter() - t0)
            if z != nodes[i]:
                raise AssertionError(f"node {i}: yielded z={z}, expected {nodes[i]}")
            _check_fields(z, so.lowres_shape, cv.perturbed_field, cv.halobox, cv.spin_temp,
                          cv.ionized_box, cv.brightness_temperature)
            if lagrangian and cv.halobox is None:
                raise AssertionError(f"node {i}: no HaloBox")
            xh.append(cv.neutral_fraction.double().mean().item())
            ion = cv.ionized_box
            if mini:
                mini_means.append((cv.spin_temp.J_21_LW.double().mean().item(),
                                   float(ion.log10_Mturnover_ave), float(ion.log10_Mturnover_MINI_ave)))
            if i in sample_at:
                samples[i] = dict(
                    z=z, pf=_moved(cv.perturbed_field, "cpu"), ts=_moved(cv.spin_temp, "cpu"),
                    ion=_moved(_without_stacks(ion), "cpu"), prev_ts=_moved(prev[0], "cpu"),
                    prev_ion=_moved(prev[1], "cpu"), prev_pf=_moved(prev[2], "cpu"), prev_z=prev[3],
                    halobox=_moved(cv.halobox, "cpu"), history=histories.pop(z, None))
            # what the next node's stages read, its Nion stacks only if it is sampled
            prev_ion = _slim_chain_ion(ion, keep_xh=cv.halobox is not None)
            prev = (cv.spin_temp,
                    prev_ion if i + 1 in sample_at else _without_stacks(prev_ion),
                    _slim_chain_pf(cv.perturbed_field, needed=mini), z)
            del ion, prev_ion
            t0 = time.perf_counter()
        total = time.perf_counter() - t_start
    finally:
        for name, attr in steps.items():
            setattr(rsds, attr, originals[name])
        xray_source.compute_xray_source_field = source_field
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del prev, cv

    if len(seconds) != len(nodes):
        raise AssertionError(f"{len(seconds)} nodes yielded of {len(nodes)}")
    for k in kernels:
        k["launches_by_path"][path] = launches[k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
        if launches[k["name"]] < 1:
            raise AssertionError(f"the {tag} lightcone never launched {k['name']}")
    if launches["cic_deposit_swept"] != len(nodes):
        raise AssertionError(f"expected {len(nodes)} deposit launches in the {tag} lightcone, got {launches}")

    later = np.array(seconds[1:])
    print(f"[{tag}] {len(nodes)} nodes in {total - t_final:.2f} s and the finalization "
          f"{t_final:.2f} s ({total:.2f} s in all) on the card: first node {seconds[0]:.3f} s, then "
          f"median {np.median(later):.4f} s a node (min {later.min():.4f}, max {later.max():.4f}); "
          f"launches {launches}; peak memory {peak:.3f} GiB")
    for name in steps:
        wall, fn, a, kw = final[name]
        busy = _device_busy_ms(lambda: fn(*a, **kw))
        busy_txt = ("device busy not measured (the profiler saw no device activity)" if busy is None
                    else f"device busy {busy[0]:.3f} ms, top kernels {busy[1]}")
        print(f"[{tag}] finalization {name}: {wall:.3f} s wall; {busy_txt}")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall, fn, a, kw = final["RSDs"]
    fn(*a, **kw)
    print(f"[{tag}] the RSD step's scratch above what it is handed: "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB")
    del final, a, kw

    cone = lc.lightcones
    shape = (so.HII_DIM, so.HII_DIM, len(lcr.lc_distances))
    miss = _check_written(written, lcr, inputs, f"{tag} lightcone")
    for q, t in cone.items():
        if tuple(t.shape) != shape or not t.is_cuda:
            raise AssertionError(f"lightcone {q}: {tuple(t.shape)} on {t.device}, expected {shape}")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"lightcone {q} is not finite")
    gxh = lc.global_quantities["neutral_fraction"]
    tb_mean = cone["brightness_temp"].double().mean().item()
    i8 = int(np.argmin(np.abs(np.asarray(nodes) - 8.0)))
    print(f"[{tag}] cone {shape} of {sorted(cone)}, {miss} boundary slice(s) unwritten; <xH> "
          f"{xh[i8]:.6f} at z={nodes[i8]:.4f} and {xh[-1]:.6f} at z={nodes[-1]}; <Tb> over the "
          f"cone {tb_mean:.5f} mK; global xH from the cone's record: first {gxh[0]:.6f}, last "
          f"{gxh[-1]:.6f}")
    if not gxh[-1] < gxh[0]:
        raise AssertionError(f"the global xH does not fall: {gxh[0]} -> {gxh[-1]}")
    if mini:
        lw, mt, mtm = (np.array(v) for v in zip(*mini_means))
        print(f"[{tag}] <J_21_LW> per node: {np.round(lw, 5).tolist()}")
        print(f"[{tag}] log10_Mturnover_MINI_ave per node: {np.round(mtm, 4).tolist()}")
        print(f"[{tag}] log10_Mturnover_ave per node: {np.round(mt, 4).tolist()}")
        # nodes where nothing ionizes yet (ionization's early exit) report 0
        if not (np.isfinite(lw).all() and lw[-1] > 0 and mtm[-1] > 5.0 and (mtm[mtm != 0] > 5.0).all()):
            raise AssertionError(f"{tag}: no Lyman-Werner background or a turnover mass out of range")
    del lc, cone
    torch.cuda.empty_cache()
    for i in sample_at:
        s = {k: _moved(v, "cuda") if k not in ("z", "prev_z", "history") else v
             for k, v in samples.pop(i).items()}
        _node_stages(inputs, ics, s, f"{tag}-stages")
        del s
        torch.cuda.empty_cache()


def headline_phase(kernels, headline):
    """Phase 9: the headline lightcone from the ICs phase 3 computed; the
    stages of the node nearest z=8."""
    inputs, ics, ics_s = headline
    lightcone_phase(kernels, inputs, ics, ics_s, "headline", "lightcone", (8.0,))


def minihalo_headline_phase(kernels):
    """Phase 10: the Munoz21 lightcone at the headline's box and ladder.  Its
    ICs (with the v_cb box) are computed and timed first, then the v_cb box
    alone, warm; the stages of the nodes nearest z=8 and z=15."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import ics as ics_module
    from py21cmfast_torch.ops import fft

    inputs = _minihalo_headline_inputs()
    so = inputs.simulation_options
    torch.cuda.reset_peak_memory_stats()
    ics, ics_s = _sync_time(lambda: p21.compute_initial_conditions(inputs))
    ics_peak = torch.cuda.max_memory_allocated() / 2**30
    d_k = fft.rfft3(ics.hires_density)
    ics_module.compute_vcb_box(inputs, d_k)
    vcb, vcb_s = _sync_time(lambda: ics_module.compute_vcb_box(inputs, d_k))
    err = (vcb - ics.lowres_vcb).abs().max().item()
    del d_k, vcb
    torch.cuda.empty_cache()
    v = ics.lowres_vcb
    print(f"[munoz21] ICs at {so.hires_shape} -> {so.lowres_shape} with the v_cb box: {ics_s:.3f} s "
          f"(first call, synchronised), peak memory {ics_peak:.3f} GiB; the v_cb box alone "
          f"{vcb_s * 1e3:.2f} ms (warm, from the hires density's transform; max-abs {err:.3e} from "
          f"the ICs' own); |v_cb| mean {v.double().mean().item():.4f} km/s, rms "
          f"{v.double().square().mean().sqrt().item():.4f}, min {v.min().item():.4f}, max "
          f"{v.max().item():.4f}")
    if tuple(v.shape) != so.lowres_shape or not bool(torch.isfinite(v).all()) or not v.min().item() >= 0:
        raise AssertionError("the Munoz21 v_cb box is malformed")
    lightcone_phase(kernels, inputs, ics, ics_s, "munoz21", "minihalo_lightcone", (8.0, 15.0))


def fixed_halos_headline_phase(kernels):
    """Phase 11: the fixed-halos lightcone at the headline's box and ladder,
    from its ICs computed and timed first; the stages of the node nearest
    z=8."""
    import torch

    import py21cmfast_torch as p21

    inputs = _fixed_halos_headline_inputs()
    if inputs.matter_options.SOURCE_MODEL != "L-INTEGRAL":
        raise AssertionError(f"{FIXED_HALOS_TEMPLATE} does not use L-INTEGRAL sources")
    ics, ics_s = _sync_time(lambda: p21.compute_initial_conditions(inputs))
    torch.cuda.empty_cache()
    lightcone_phase(kernels, inputs, ics, ics_s, "fixed-halos", "fixed_halos_lightcone", (8.0,))


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this check runs only on an NVIDIA GPU")
    import py21cmfast_torch  # noqa: F401  (fails outside a checkout of the repository)

    t0 = time.perf_counter()
    card_info()
    build_kernels()
    entry, headline = kernel_phase()
    kernels = [entry]
    dens_swept = small_coeval_phase()
    perturb_paths_phase(dens_swept)
    evolving_small_phase()
    lightcone_small_phase()
    minihalo_small_phase()
    fixed_halos_small_phase()
    main_path_phase(kernels)
    stage_phase()
    scroll_stage_phase(*scroll_phase(kernels))
    headline_phase(kernels, headline)
    del headline
    torch.cuda.empty_cache()
    minihalo_headline_phase(kernels)
    torch.cuda.empty_cache()
    fixed_halos_headline_phase(kernels)
    print(f"[total] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
