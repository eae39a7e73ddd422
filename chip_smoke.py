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
  4g. discrete halos at golden size, card against CPU, the draws made by CPU
     generators: DexM with one stratum grid, the grid sampler's chunk,
     _fix_mass_keep and the MASS- and NUMBER-LIMITED progenitor cores
     (identical keep masks and centres, masses within 1e-6); then the
     latest-discrete and minihalos-discrete lightcones, 5 nodes, as in 4f
     with equal halo counts at every node;
  4h. the slice of the PARTITION and BINARY-SPLIT samplers, photon
     conservation and the non-integer perturb at golden size, card against
     CPU: the two progenitor cores fed one set of CPU-generator draws; the
     Z-PHOTONCONS calibration of both devices on one realization (the same
     z grid, the deltaz curve) and its 5-node Ts lightcone per node and
     cone; the ALPHA- and F-PHOTONCONS fits and coevals; a coeval at
     DIM/HII_DIM = 2.5 (the scatter route, no kernel launch);
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
     CUDA-event times of the displacement scatter;
  12. the sixth main path: the latest-discrete template (CHMF-SAMPLER with
     MASS-LIMITED progenitors, USE_TS_FLUCT, INHOMOGENEOUS) at 128^3 / 384^3
     in a 192 Mpc box (its 1.5 Mpc cell) down the headline's ladder cut to
     z=8 (72 nodes), as phase 9, from the default CUDA generators: the
     catalog chain's wall, whole and by step, the halo counts, the host
     memory of the waiting catalogs, a
     statistical gate on the z=8 grid sample (its count within 1% of the
     expected, each of 4 mass octaves within 5 sigma of the conditional MF),
     and the node nearest z=8 by stage (perturb_halo_catalog, the halo
     properties, the halo CIC with CUDA-event times, the sub-sampler grids,
     the XraySourceBox, Ts, ionize, Tb).
  13. the headline lightcone of phase 9 under Z-PHOTONCONS (run right after
     phase 9, from its ICs), its ladder cut to z=8: the calibration's
     coevals, z range and wall, seconds per node, <xH> and <Tb> at z=8
     beside phase 9's, peak memory, one deposit launch a node and a
     calibration step;
  14. generate_coeval of the latest-discrete template at phase 12's box
     down to z=10, once with PARTITION and once with BINARY-SPLIT
     progenitors: the catalog chain's wall and parts, the halo counts, the
     seconds per node, the first progenitor step's mass octaves against the
     conditional MF, the binary split's spilled rows and force-saved
     branches;
  15. run_global_evolution (the 0-D history) on the headline's inputs on
     the card against the same run on the CPU, which runs in a process of
     its own beside the card's phases from the start;
  16. (right after phase 13) the command line: `python -m py21cmfast_torch
     template avail` and `run params` in subprocesses, then `cli.main` of
     `run lightcone` on the headline's settings cut to z=10 (61 nodes, one
     deposit launch each), its wall, launches, peak memory and output line;
     the power spectrum of a z~8 chunk of phase 9's Tb cone on the card
     against the CPU, the Thomson optical depth of phase 9's global xH, and
     convert_halo_properties of 1e7 masses on the card against the CPU.
  17. (last) the multi-GPU layer, py21cmfast_torch.parallel: 17a
     run_sharded_coeval of the simple box at z=8 over NCCL with one rank in
     this process; 17b two ranks sharing the one card (gloo, collectives
     through host memory) on the headline's box at z=8; 17c the headline's
     physics as run_sharded_lightcone at 128^3 over 9 nodes; 17d the
     latest-discrete template at 64^3 to z=10 (the slab sampler's
     statistics, the sharded painting); each against the single-device run
     of the same seed, with its wall by part, the time inside collectives
     and each rank's peak memory; 17e 17b over NCCL with one card a rank,
     only where there are two cards.
The line before the last is a JSON object of kernel numbers; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
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
    the coeval evolves down the golden ladder (25 -> 10.5, 5 nodes).  The
    deposit kernel is launched once a node at an integer DIM/HII_DIM and
    never at another ratio (the scatter route)."""
    import py21cmfast_torch as p21
    from py21cmfast_torch.models import perturb
    from py21cmfast_torch.ops import deposit

    inputs = p21.InputParameters(random_seed=SEED).evolve_input_structs(**{**GOLDEN_SIZE, **over})
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
    expected = n_nodes if perturb.uses_swept_deposit(inputs) else 0
    if deposit.cic_deposit_swept.launches != launches + expected:
        raise AssertionError(
            f"{label}: the coeval on the card launched the deposit kernel "
            f"{deposit.cic_deposit_swept.launches - launches} times, expected {expected}")
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


def _discrete_halos_stages(inputs, ics, s, z):
    """The sampled-halo stages of one node: perturb_halo_catalog from the
    node's catalog (on the card), the HaloBox whole and by its parts (the
    halo properties, the halo CIC, the sub-sampler grids; the parts are not
    summed into the node), the XraySourceBox from the scroll's history and
    the Ts step that reads it, as (name, prepare, fn, summed)."""
    import torch

    from py21cmfast_torch.models import halobox as hbm
    from py21cmfast_torch.models import halos, spintemp, xray_source
    from py21cmfast_torch.models.hmf import set_scaling_constants
    from py21cmfast_torch.ops import grids

    so = inputs.simulation_options
    parts = {}
    lo = so.lowres_shape

    def perturb_catalog():
        return halos.perturb_halo_catalog(z, inputs, ics, s["catalog"])

    def halobox_whole():
        return hbm.compute_halo_grid(
            z, inputs, parts["pt"], previous_spin_temp=s["prev_ts"],
            previous_ionized_box=s["prev_ion"], lagrangian_delta=ics.lowres_density,
            lowres_vcb=ics.lowres_vcb, ics=ics)

    def prep_pt():
        parts["pt"] = perturb_catalog()
        parts["pos"] = grids.true_div(parts["pt"].halo_coords, so.box_len / so.HII_DIM)

    def props():
        pt, sc = parts["pt"], set_scaling_constants(z, inputs)
        mt_a, mt_m, *_ = hbm._halo_turnovers(z, inputs, sc, pt.halo_masses, parts["pos"],
                                             s["prev_ts"], s["prev_ion"], ics.lowres_vcb,
                                             torch.device("cuda"))
        return hbm._halo_props_kernel(
            pt.halo_masses, pt.star_rng, pt.sfr_rng, pt.xray_rng, mt_a, mt_m,
            hbm._scaling_consts_dict(sc, inputs.cosmology, z, inputs.astro_options),
            **hbm._props_flags(sc, inputs.astro_options))

    def prep_cic():
        prep_pt()
        p = props()
        dep = [p["n_ion"], p["sfr"], p["wsfr"], p["xray38"], p["stellar"],
               torch.ones_like(parts["pt"].halo_masses)]
        if inputs.astro_options.USE_MINI_HALOS:
            dep += [p["sfr_mini"], p["stellar_mini"]]
        parts["dep"] = dep

    def cic():
        return hbm._cic_deposit(parts["pt"].halo_masses, parts["pos"], parts["dep"], lo)

    def sub_grid():
        mt = (None, None)
        if inputs.astro_options.USE_MINI_HALOS:
            mt = hbm._mcrit_grids(z, inputs, set_scaling_constants(z, inputs), s["prev_ts"],
                                  s["prev_ion"], ics.lowres_vcb)
        return hbm.compute_fixed_halo_grid(z, inputs, ics.lowres_density,
                                           m_max=so.SAMPLER_MIN_MASS, mt_a_grid=mt[0],
                                           mt_m_grid=mt[1], ics=ics)

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
        ("perturb_halo_catalog", None, perturb_catalog, True),
        ("HaloBox", prep_pt, halobox_whole, True),
        ("halo properties", prep_pt, props, False),
        ("halo CIC", prep_cic, cic, False),
        ("sub-sampler grid", None, sub_grid, False),
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
    mo = inputs.matter_options
    sampler = mo.source_model_uses_halo_sampler
    lagrangian = mo.source_model_uses_lagrangian_grids
    parts = {}

    def ts_step():
        return spintemp.compute_spin_temperature(
            z, inputs, s["pf"], prev_state=s["prev_ts"], prev_redshift=s["prev_z"],
            initial_conditions=ics, previous_ionized_box=s["prev_ion"])

    stages = [("perturb", None, lambda: p21.perturb_field(z, inputs, ics), True)]
    if sampler:
        lagr_stages, parts = _discrete_halos_stages(inputs, ics, s, z)
        stages += lagr_stages
    elif lagrangian:
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
    if sampler:
        prepare = next(st[1] for st in stages if st[0] == "halo CIC")
        prepare()
        ms = _event_median_ms(lambda: next(st[2] for st in stages if st[0] == "halo CIC")(), reps=10)
        print(f"[{tag}] z={z:.3f} halo CIC ({len(parts['dep'])} property fields of "
              f"{parts['pt'].n_halos} halos onto {inputs.simulation_options.lowres_shape}, 8 CIC "
              f"corners each): {ms:.3f} ms a call (CUDA events, median of 10)")
        parts.clear()
    elif lagrangian:
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


def _card_vs_cpu_lagrangian(tag, label, inputs):
    """One golden-size lightcone with Lagrangian sources (dvdr and RSDs on)
    on the card against the CPU, from one hires density.  With a halo
    sampler both devices run the catalog chain from CPU generators of one
    seed (`halos.default_generator` on the CPU), so the draws are the same,
    and the halo counts must be equal at every node.  Per node: the HaloBox
    grids and every XraySourceBox stack at most 1e-3 of the cells off by
    1e-4 of the maximum (of the stack's shell); Ts, Tk, x_e, J_21_LW, xH and
    Tb as in phase 4e; then the cones as in 4d."""
    import py21cmfast_torch as p21
    from py21cmfast_torch.models import halos, xray_source

    ics_cpu = p21.compute_initial_conditions(inputs, device="cpu")
    ics_gpu = p21.compute_initial_conditions(inputs, initial_density=ics_cpu.hires_density.numpy())
    source_field = xray_source.compute_xray_source_field
    determine = halos.determine_halo_catalog
    runs, nodes, counts = {}, {}, {}
    for dev, ics in (("cpu", ics_cpu), ("cuda", ics_gpu)):
        sources, counts[dev] = {}, {}

        def recorded(z, *a, sources=sources, **kw):
            out = source_field(z, *a, **kw)
            sources[z] = _host_fields(out, SOURCE_FIELDS)
            return out

        def from_cpu_generator(z, inputs_, *a, counts=counts[dev], **kw):
            kw["generator"] = halos.default_generator(inputs_, z, "cpu")
            cat = determine(z, inputs_, *a, **kw)
            counts[z] = cat.n_halos
            return cat

        lcr, written = _tracked_lightconer(inputs)
        nodes[dev] = []
        xray_source.compute_xray_source_field = recorded
        halos.determine_halo_catalog = from_cpu_generator
        try:
            for z, cv, lc in p21.generate_lightcone(
                    inputs, lightconer=lcr, initial_conditions=ics, device=dev):
                if z is not None:
                    fields, _, _ = _minihalo_node(cv)
                    fields.update(_host_fields(cv.halobox, HALOBOX_FIELDS))
                    nodes[dev].append((z, fields))
        finally:
            xray_source.compute_xray_source_field = source_field
            halos.determine_halo_catalog = determine
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
        halo_txt = ""
        if counts["cpu"]:
            n_c, n_g = counts["cpu"][z], counts["cuda"][z]
            halo_txt = f"halos {n_g} card vs {n_c} CPU; "
            ok &= n_c == n_g
        print(f"[{tag}] {label} z={z:.3f}: {halo_txt}worst cell rel "
              f"{{{', '.join(f'{k}: {v:.2e}' for k, v in worst.items())}}} (limit 1e-3); xH "
              f"flipped share {flipped:.2e}; (share off by > 1e-4 max, max err / max) "
              f"{{{', '.join(f'{k}: ({v[0]:.2e}, {v[1]:.2e})' for k, v in shares.items())}}}")
    if not ok:
        raise AssertionError(f"the golden-size {label}'s nodes on the card disagree with the CPU run")
    if n_sources != len(inputs.node_redshifts) - 1:
        raise AssertionError(f"{label}: {n_sources} XraySourceBoxes in {len(nodes['cpu'])} nodes")
    if inputs.astro_options.LYA_MULTIPLE_SCATTERING and inputs.astro_options.USE_MINI_HALOS and (
            nodes["cuda"][-1][1]["source"]["filtered_sfr_lw"] is None):
        raise AssertionError(f"{label}: no straight-line LW shells")
    _card_vs_cpu_cones(label, inputs, runs)


def fixed_halos_small_phase():
    """Phase 4f: golden-size L-INTEGRAL lightcones on the card against the
    CPU (`_card_vs_cpu_lagrangian`): the fixed-halos template, with
    minihalos, and with minihalos and the Lya multiple-scattering window
    (straight-line LW shells)."""
    import py21cmfast_torch as p21

    size = {k: v for k, v in GOLDEN_SIZE.items() if k != "SOURCE_MODEL"}
    for label, over in FIXED_HALOS_SMALL.items():
        inputs = p21.InputParameters.from_template(
            FIXED_HALOS_TEMPLATE, random_seed=SEED
        ).evolve_input_structs(**size, R_BUBBLE_MAX=12.0, **over).with_logspaced_redshifts(10.5, 25.0)
        if inputs.matter_options.SOURCE_MODEL != "L-INTEGRAL":
            raise AssertionError(f"{FIXED_HALOS_TEMPLATE} does not use L-INTEGRAL sources")
        _card_vs_cpu_lagrangian("fixed-halos-small", label, inputs)


# phase 4g's golden-size discrete-halo lightcones, by template
DISCRETE_TEMPLATE = "latest-discrete"
DISCRETE_SMALL = {"latest-discrete lightcone": DISCRETE_TEMPLATE,
                  "minihalos-discrete lightcone": "minihalos-discrete"}
# masses of the card-vs-CPU core checks: the same ln M on both devices (log(u)
# is rounded once from float64), then float32 exp, within 2 ulps on each
HALO_MASS_REL = 1e-6


def _same_halos(label, m_c, m_g, keep_c=None, keep_g=None, pos_c=None, pos_g=None, cell=None):
    """Card and CPU halos of one core: identical keep masks (or counts), the
    masses within HALO_MASS_REL of their values, positions within 1e-6 of a
    cell."""
    import torch

    if keep_c is not None and not torch.equal(keep_c.cpu(), keep_g.cpu()):
        n = (keep_c.cpu() != keep_g.cpu()).sum().item()
        raise AssertionError(f"{label}: {n} keep-mask entries differ between the card and the CPU")
    m_c, m_g = m_c.cpu().double(), m_g.cpu().double()
    if m_c.shape != m_g.shape:
        raise AssertionError(f"{label}: {tuple(m_g.shape)} on the card, {tuple(m_c.shape)} on the CPU")
    rel = ((m_g - m_c).abs() / m_c.abs().clamp_min(1e-30)).max().item() if m_c.numel() else 0.0
    txt = f"max mass rel {rel:.2e} (limit {HALO_MASS_REL:.0e})"
    ok = rel <= HALO_MASS_REL
    if pos_c is not None:
        err = (pos_g.cpu().double() - pos_c.cpu().double()).abs().max().item() if pos_c.numel() else 0.0
        txt += f", max position err {err:.2e} Mpc (limit {1e-6 * cell:.2e})"
        ok &= err <= 1e-6 * cell
    print(f"[discrete-small] {label}: {m_c.numel()} entries identical in both; {txt}")
    if not ok:
        raise AssertionError(f"{label}: the card disagrees with the CPU")


def discrete_cores_phase():
    """Phase 4g, first part: the sampler's deterministic cores on the card
    against the CPU at golden size, each fed one set of draws made by a CPU
    generator: DexM with one stratum grid (identical centres, masses and
    in_halo mask), the grid sampler's chunk, `_fix_mass_keep` on random
    inputs, and `_progenitor_draws` MASS- and NUMBER-LIMITED on a catalog of
    20000 descendants."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import halos

    size = {k: v for k, v in GOLDEN_SIZE.items() if k != "SOURCE_MODEL"}
    inputs = p21.InputParameters.from_template(DISCRETE_TEMPLATE, random_seed=SEED).evolve_input_structs(
        **size, R_BUBBLE_MAX=15.0)
    so = inputs.simulation_options
    z = 10.5
    ics_cpu = p21.compute_initial_conditions(inputs, device="cpu")
    ics_gpu = p21.compute_initial_conditions(inputs, initial_density=ics_cpu.hires_density.numpy())
    gen = torch.Generator().manual_seed(SEED)

    strata = halos.draw_strata(inputs, gen, "cpu")
    out = {dev: halos.dexm_halo_grid(z, inputs, ics, stratum_grid=strata, device=dev)
           for dev, ics in (("cpu", ics_cpu), ("cuda", ics_gpu))}
    (g_c, in_c), (g_g, in_g) = out["cpu"], out["cuda"]
    n_c, n_g = int((g_c > 0).sum()), int((g_g > 0).sum())
    flips = int((in_c != in_g.cpu()).sum())
    print(f"[discrete-small] DexM at z={z} on {so.hires_shape}: {n_g} centres on the card, {n_c} on "
          f"the CPU; in_halo cells differing {flips} of {int(in_c.sum())}")
    if not (torch.equal(g_c, g_g.cpu()) and flips == 0 and n_c > 0):
        raise AssertionError("DexM on the card disagrees with the CPU")
    _, _, excl = halos._dexm_catalog(inputs, g_c, in_c)

    h = halos.grid_sampler_tables(z, inputs, ics_cpu.lowres_density, excl)
    n_exp = torch.as_tensor(h["n_exp"].astype(np.float32))
    draws = halos._grid_draws(n_exp, h["k_max"], gen, "cpu")
    res = {}
    for dev in ("cpu", "cuda"):
        res[dev] = halos._grid_chunk(
            inputs, h, torch.as_tensor(h["delta_z"].astype(np.float32), device=dev),
            torch.as_tensor(h["inv_tab"].astype(np.float32), device=dev), 0,
            *(d.to(dev) for d in draws))
    _same_halos(f"grid sampler ({len(n_exp)} cells, k_max {h['k_max']})", res["cpu"][0],
                res["cuda"][0], pos_c=res["cpu"][1], pos_g=res["cuda"][1],
                cell=so.box_len / so.HII_DIM)

    rng = np.random.default_rng(SEED)
    m = torch.as_tensor(np.exp(rng.uniform(np.log(1e8), np.log(1e11), (4096, 64))).astype(np.float32))
    tgt = (m.sum(dim=1) * torch.as_tensor(rng.uniform(0.0, 1.2, 4096).astype(np.float32)))
    sel = torch.rand(4096, generator=gen) < 0.5
    u = torch.rand((4096, 64), generator=gen)
    keep = {dev: halos._fix_mass_keep(m.to(dev), tgt.to(dev), sel.to(dev), u.to(dev))
            for dev in ("cpu", "cuda")}
    _same_halos("_fix_mass_keep (4096 x 64 random draws)", m[keep["cpu"]], m[keep["cuda"].cpu()],
                keep["cpu"], keep["cuda"])

    n = 20000
    masses = torch.as_tensor(np.exp(rng.uniform(np.log(1e8), np.log(1e11), n)).astype(np.float32))
    for method in ("MASS-LIMITED", "NUMBER-LIMITED"):
        inp = inputs.evolve_input_structs(SAMPLE_METHOD=method)
        t = halos.progenitor_tables(z + 0.3, inp, z, float(masses.max()))
        cond_t, m_tgt, n_exp_d, _ = halos._descendant_conditions(inp, t, masses)
        d = halos._progenitor_rng(n_exp_d.float(), halos.PROGENITOR_K_MAX,
                                  method == "NUMBER-LIMITED", gen, "cpu")
        out = {dev: halos._progenitor_draws(
            cond_t.float().to(dev), m_tgt.float().to(dev),
            torch.as_tensor(t["inv_tab"].astype(np.float32), device=dev), so.MIN_LOGPROB,
            so.SAMPLER_MIN_MASS, **{k: v.to(dev) for k, v in d.items()}) for dev in ("cpu", "cuda")}
        (mc, kc), (mg, kg) = out["cpu"], out["cuda"]
        _same_halos(f"_progenitor_draws {method} ({n} descendants)", mc[kc], mg[kg].cpu(), kc, kg)


def discrete_small_phase():
    """Phase 4g: the cores (`discrete_cores_phase`), then the golden-size
    latest-discrete (R_BUBBLE_MAX=15) and minihalos-discrete lightcones, 5
    nodes, on the card against the CPU (`_card_vs_cpu_lagrangian`)."""
    import py21cmfast_torch as p21

    discrete_cores_phase()
    size = {k: v for k, v in GOLDEN_SIZE.items() if k != "SOURCE_MODEL"}
    for label, template in DISCRETE_SMALL.items():
        inputs = p21.InputParameters.from_template(template, random_seed=SEED).evolve_input_structs(
            **size, R_BUBBLE_MAX=15.0).with_logspaced_redshifts(10.5, 25.0)
        if not inputs.matter_options.source_model_uses_halo_sampler:
            raise AssertionError(f"{template} does not sample halos")
        _card_vs_cpu_lagrangian("discrete-small", label, inputs)


# phase 4h: photon conservation at golden size.  The Z-PHOTONCONS lightcone
# takes the golden Ts + INHOMOGENEOUS options with R_BUBBLE_MAX=15, and the
# ALPHA/F coevals its box without Ts and recombinations: the three calibrate
# on one calibration box (Ts, recombinations and the correction off,
# R_BUBBLE_MAX=15), run once on each device
PHOTONCONS_SMALL = dict(USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=15.0)
# the mean xH at which the calibration's step changes (0.5, 0.15, 0.05)
CALIBRATION_THRESHOLDS = (0.9, 0.3, 0.01)
# the sampler cores' mass bounds, as the CPU tests hold the port to the JAX
# package (tests/test_torch_samplers.py): the partition's masses; the binary
# split's, sorted within each descendant, 99% within and all within
PARTITION_MASS_REL = 2e-4
SPLIT_MASS_REL_99, SPLIT_MASS_REL_MAX = 2e-5, 1e-2


def _step_uniforms(shape, t):
    """Step t's uniforms for every descendant (and slot), from a CPU
    generator seeded by the step."""
    import torch

    return torch.rand(shape, generator=torch.Generator().manual_seed(SEED * 1000 + t))


def _shared_sampler_draws():
    """The partition's and the binary split's draw factories, drawing every
    step's uniforms for the whole chunk on the CPU and handing each device
    those of the rows (and slots) it asks for."""
    def partition_rng(n, use_st, generator, dev):
        def draw(t, rows):
            full = _step_uniforms((10, n), t)
            r = rows.cpu()
            out = dict(u=full[0, r].clamp(min=1e-7), u1=full[1:5, r].clamp(min=1e-12),
                       u2=full[5:9, r])
            if use_st:
                out["u_acc"] = full[9, r]
            return {k: v.to(dev) for k, v in out.items()}
        return draw

    def split_rng(n, generator, dev):
        def draw(t, rows, slots):
            full = _step_uniforms((3, n, 64), t)[:, rows.cpu(), slots.cpu()]
            return tuple(full[i].to(dev) for i in range(3))
        return draw
    return partition_rng, split_rng


def sampler_cores_phase():
    """Phase 4h, first part: the PARTITION (HMF 'ST') and BINARY-SPLIT
    progenitor cores at golden size on the card against the CPU, both fed
    one set of CPU-generator draws (`_shared_sampler_draws`): 20000
    descendants of log-uniform mass in [1e8, 1e11] at z=10.5 sampled to
    z=10.8.  Both: the progenitors of the same descendants in the same
    order (the keep masks, compacted); the partition's masses within
    PARTITION_MASS_REL, the binary split's sorted within each descendant
    99% within SPLIT_MASS_REL_99 and all within SPLIT_MASS_REL_MAX."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import halos

    size = {k: v for k, v in GOLDEN_SIZE.items() if k != "SOURCE_MODEL"}
    base = p21.InputParameters.from_template(DISCRETE_TEMPLATE, random_seed=SEED).evolve_input_structs(
        **size, R_BUBBLE_MAX=15.0)
    z, n = 10.5, 20000
    rng = np.random.default_rng(SEED)
    masses = torch.as_tensor(np.exp(rng.uniform(np.log(1e8), np.log(1e11), n)).astype(np.float32))
    originals = (halos._partition_rng, halos._binary_split_rng)
    halos._partition_rng, halos._binary_split_rng = _shared_sampler_draws()
    try:
        for method, chunk in (("PARTITION", halos._partition_chunk),
                              ("BINARY-SPLIT", halos._binary_split_chunk)):
            inp = base.evolve_input_structs(SAMPLE_METHOD=method)
            h = halos.progenitor_tables(z + 0.3, inp, z, float(masses.max()), inverse=False)
            out = {}
            for dev in ("cpu", "cuda"):
                md = masses.to(dev)
                cond_t, m_tgt, n_exp, _ = halos._descendant_conditions(inp, h, md)
                (rows, m), t = _sync_time(lambda: chunk(inp, h, md, cond_t, m_tgt, n_exp, None, dev))
                out[dev] = (rows.cpu(), m.cpu().double(), t)
            (rc, mc, tc), (rg, mg, tg) = out["cpu"], out["cuda"]
            same = torch.equal(rc, rg)
            if method == "PARTITION":
                rel = ((mg - mc).abs() / mc).max().item() if same and mc.numel() else float("inf")
                ok = same and rel <= PARTITION_MASS_REL
                txt = (f"progenitors of the same descendants in the same order {same}, max mass "
                       f"rel {rel:.2e} (limit {PARTITION_MASS_REL:.0e})")
            else:
                # each descendant's progenitors, sorted
                sc, sg = (m[np.lexsort((m.numpy(), rc.numpy()))] for m in (mc, mg))
                rel = (sg - sc).abs() / sc if same else torch.full((1,), float("inf"))
                q99, top = (torch.quantile(rel, 0.99).item(), rel.max().item()) if rel.numel() else (0, 0)
                ok = same and q99 <= SPLIT_MASS_REL_99 and top <= SPLIT_MASS_REL_MAX
                txt = (f"progenitor counts a descendant identical {same}, sorted masses rel: 99% "
                       f"{q99:.2e} (limit {SPLIT_MASS_REL_99:.0e}), max {top:.2e} (limit "
                       f"{SPLIT_MASS_REL_MAX:.0e})")
            print(f"[samplers-small] {method} core, {n} descendants z={z} -> {z + 0.3}: "
                  f"{rc.numel()} progenitors; {txt}; {tg:.3f} s on the card, {tc:.3f} s on the CPU")
            if not ok:
                raise AssertionError(f"the {method} core on the card disagrees with the CPU")
    finally:
        halos._partition_rng, halos._binary_split_rng = originals


@contextlib.contextmanager
def _one_realization(cals):
    """While the block runs, ICs asked for on the card without a density
    take the CPU generator's, so that both devices' photon-conservation
    calibrations run on one realization, and each device calibrates one
    calibration box once (recorded in `cals` by device)."""
    import torch

    from py21cmfast_torch.models import ics as ics_module
    from py21cmfast_torch.models import photoncons

    compute_ics = ics_module.compute_initial_conditions
    calibrate = photoncons.calibrate_photon_cons

    def shared_ics(inputs, initial_density=None, *, device="cuda"):
        if initial_density is None and torch.device(device).type == "cuda":
            initial_density = compute_ics(inputs, device="cpu").hires_density.numpy()
        return compute_ics(inputs, initial_density=initial_density, device=device)

    def once(inputs, z_ana=None, q_ana=None, *, device="cuda"):
        dev = torch.device(device).type
        key = (dev, inputs.evolve_input_structs(
            PHOTON_CONS_TYPE="NO-PHOTONCONS", USE_TS_FLUCT=False, RECOMB_MODEL="NONE",
            R_BUBBLE_MAX=15.0 if inputs.astro_options.uses_recombination
            else inputs.astro_params.R_BUBBLE_MAX).full_hash)
        if key not in cals:
            cals[key] = _sync_time(lambda: calibrate(inputs, z_ana, q_ana, device=device))
        return cals[key][0]

    ics_module.compute_initial_conditions = shared_ics
    photoncons.calibrate_photon_cons = once
    try:
        yield
    finally:
        ics_module.compute_initial_conditions = compute_ics
        photoncons.calibrate_photon_cons = calibrate


def _same_states(label, states):
    """The photon-conservation states of the card and the CPU: the same
    calibration z grid; for the Z state each step's mean xH within 1e-3
    (with its margin to the step thresholds) and the deltaz(xH) curve within
    1e-2, for a fit its intercept and slope within 1e-2 of their values."""
    c, g = states["cpu"], states["cuda"]
    same_grid = np.array_equal(c.z_cal, g.z_cal)
    txt = (f"calibration z grids identical {same_grid} ({len(c.z_cal)} steps, z {c.z_cal[0]:.3f} -> "
           f"{c.z_cal[-1]:.3f})")
    ok = same_grid
    if hasattr(c, "xh_cal"):
        xh_err = float(np.abs(c.xh_cal - g.xh_cal).max()) if same_grid else float("inf")
        margin = min(float(np.abs(c.xh_cal - t).min()) for t in CALIBRATION_THRESHOLDS)
        txt += (f", max |dxH| {xh_err:.2e} (limit 1e-3), the CPU's xH {margin:.2e} from the "
                f"nearest step threshold")
        ok &= xh_err <= 1e-3
    if hasattr(c, "deltaz_vals"):
        dz = (float(np.abs(c.deltaz_vals - g.deltaz_vals).max())
              if c.deltaz_vals.shape == g.deltaz_vals.shape else float("inf"))
        txt += f", deltaz(xH) max |card - CPU| {dz:.2e} (limit 1e-2)"
        ok &= dz <= 1e-2
    else:
        rel = [abs(getattr(g, k) - getattr(c, k)) / abs(getattr(c, k)) for k in ("fit_yint", "fit_slope")]
        txt += (f", fit {g.fit_yint:.6g} + {g.fit_slope:.6g} Q card vs {c.fit_yint:.6g} + "
                f"{c.fit_slope:.6g} Q CPU (rel {rel[0]:.2e}, {rel[1]:.2e}; limit 1e-2)")
        ok &= max(rel) <= 1e-2
    print(f"[photoncons-small] {label}: {txt}")
    if not ok:
        raise AssertionError(f"{label}: the card's photon-conservation state disagrees with the CPU's")


def photoncons_small_phase():
    """Phase 4h, second part: golden-size photon conservation, card against
    CPU, both calibrating on one realization (`_one_realization`): the
    states (`_same_states`), then the 5-node Z-PHOTONCONS lightcone (Ts,
    INHOMOGENEOUS) per node Ts, Tk, x_e (every cell within 1e-3 of its
    value, the mean within 1e-4), xH (at most 1e-3 of the cells off by
    1e-3) and Tb (at most 1e-3 of the cells off by 1e-4 of the maximum), then
    the cones as in 4d; then the ALPHA- and F-PHOTONCONS coevals down the
    same ladder as in phase 4."""
    import py21cmfast_torch as p21
    from py21cmfast_torch.drivers import coeval
    from py21cmfast_torch.models import photoncons

    label = "Z-PHOTONCONS lightcone"
    cals = {}
    with _one_realization(cals):
        inputs = p21.InputParameters(random_seed=SEED).evolve_input_structs(
            **GOLDEN_SIZE, **PHOTONCONS_SMALL, PHOTON_CONS_TYPE="Z-PHOTONCONS",
        ).with_logspaced_redshifts(10.5, 25.0)
        states = {dev: photoncons.setup_photon_cons(inputs, device=dev) for dev in ("cpu", "cuda")}
        _same_states(label, states)
        ics_cpu = p21.compute_initial_conditions(inputs, device="cpu")
        ics_gpu = p21.compute_initial_conditions(inputs, initial_density=ics_cpu.hires_density.numpy())
        runs, nodes = {}, {}
        for dev, ics in (("cpu", ics_cpu), ("cuda", ics_gpu)):
            lcr, written = _tracked_lightconer(inputs)
            nodes[dev] = []
            for z, cv, lc in p21.generate_lightcone(
                    inputs, lightconer=lcr, initial_conditions=ics, device=dev):
                if z is not None:
                    nodes[dev].append((z, _minihalo_node(cv)[0]))
            runs[dev] = (lc, written, _check_written(written, lcr, inputs, f"{label} on {dev}"))
        ok = True
        for (z, c), (_, g) in zip(nodes["cpu"], nodes["cuda"]):
            worst = {}
            for name in ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction"):
                cc, gg = c[name], g[name]
                worst[name] = ((gg - cc).abs() / cc.abs().clamp_min(1e-30)).max().item()
                mean_rel = abs(gg.mean().item() - cc.mean().item()) / max(abs(cc.mean().item()), 1e-30)
                ok &= worst[name] <= 1e-3 and mean_rel <= 1e-4
            flipped = ((g["neutral_fraction"] - c["neutral_fraction"]).abs() > 1e-3).double().mean().item()
            tb_c, tb_g = c["brightness_temp"], g["brightness_temp"]
            share = ((tb_g - tb_c).abs() > 1e-4 * tb_c.abs().max()).double().mean().item()
            ok &= flipped <= 1e-3 and share <= 1e-3
            print(f"[photoncons-small] {label} z={z:.3f} (computed at z={states['cuda'].adjusted_redshift(z):.4f}"
                  f" on the card, {states['cpu'].adjusted_redshift(z):.4f} on the CPU): <xH> "
                  f"{g['neutral_fraction'].mean().item():.6f} card vs {c['neutral_fraction'].mean().item():.6f}"
                  f" CPU; worst cell rel {{{', '.join(f'{k}: {v:.2e}' for k, v in worst.items())}}} "
                  f"(limit 1e-3); xH flipped share {flipped:.2e}; Tb share off by > 1e-4 max {share:.2e}")
        if not ok:
            raise AssertionError(f"the golden-size {label}'s nodes on the card disagree with the CPU run")
        _card_vs_cpu_cones(label, inputs, runs)

        for pc in ("ALPHA-PHOTONCONS", "F-PHOTONCONS"):
            over = dict(R_BUBBLE_MAX=15.0, PHOTON_CONS_TYPE=pc)
            inp = p21.InputParameters(random_seed=SEED).evolve_input_structs(
                **GOLDEN_SIZE, **over).with_logspaced_redshifts(10.5, 25.0)
            # the states first, so that the coevals' deposit launches are their nodes'
            _same_states(f"{pc} coeval", {dev: coeval.setup_photon_cons(inp, device=dev)
                                          for dev in ("cpu", "cuda")})
            _card_vs_cpu_coeval(pc, nodes=True, **over)
    for (dev, _), (_, t) in cals.items():
        print(f"[photoncons-small] the calibration on the {dev}: {t:.2f} s")
    if len(cals) != 2:
        raise AssertionError(f"expected one calibration box a device, got {len(cals)}")


def slice_small_phase():
    """Phase 4h: the samplers' cores, photon conservation and a perturb at
    a non-integer DIM/HII_DIM (HII_DIM=24 with DIM=60, the scatter route, no
    kernel launch) at golden size, on the card against the CPU."""
    sampler_cores_phase()
    photoncons_small_phase()
    _card_vs_cpu_coeval("DIM/HII_DIM = 2.5", DIM=60)


HEADLINE_SEED = 3
HEADLINE_Z_END = 5.0
# phases 10 and 11 run the headline's box and ladder down to z=8 only (72 of
# its 92 nodes): the depth cut that keeps the whole script within its time
# once phases 4h and 13-15 joined it
CUT_Z_END = 8.0
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
    box and node ladder, down to CUT_Z_END."""
    import py21cmfast_torch as p21

    return p21.InputParameters.from_template(
        MINIHALO_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**HEADLINE_BOX).with_logspaced_redshifts(CUT_Z_END)


def _fixed_halos_headline_inputs():
    """The fixed-halos template (L-INTEGRAL, USE_EXP_FILTER, CELL_RECOMB,
    USE_TS_FLUCT, inhomogeneous recombinations, R_BUBBLE_MAX=50) at the
    headline's box and node ladder, down to CUT_Z_END."""
    import py21cmfast_torch as p21

    return p21.InputParameters.from_template(
        FIXED_HALOS_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**HEADLINE_BOX).with_logspaced_redshifts(CUT_Z_END)


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


def lightcone_phase(kernels, inputs, ics, ics_s, tag, path, sample_z, setup_launches=None,
                    keep_tb_at=None):
    """A full-size lightcone through generate_lightcone with dvdr and RSDs,
    from ICs computed before (as bench.py hands them in); launch counts zeroed
    just before and read just after (one deposit launch per node, and
    `setup_launches()` more where the run's setup deposits too).  Then the
    finalization's device-busy times and the stages of the nodes nearest each
    of `sample_z`, recomputed from the state the scroll handed them; that
    state is kept on the host meanwhile, so that it adds nothing to the run's
    peak memory.  Returns the nodes, their <xH> and <Tb>, the global xH the
    cone recorded, the seconds of each node and the peak memory; with
    `keep_tb_at` also a copy of the HII_DIM slices of the finished Tb cone
    centred nearest that redshift, on the card, with its redshift and box
    lengths."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch import rsds
    from py21cmfast_torch.drivers.coeval import _slim_chain_ion, _slim_chain_pf
    from py21cmfast_torch.models import xray_source
    from py21cmfast_torch.ops import deposit

    so = inputs.simulation_options
    mini = inputs.astro_options.USE_MINI_HALOS
    lagrangian = inputs.matter_options.source_model_uses_lagrangian_grids
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

    # sampled halos: the sampled nodes' catalogs, kept on the host
    from py21cmfast_torch.models import halos
    catalogs = {}
    perturb_catalog = halos.perturb_halo_catalog

    def recorded_catalog(z, inputs_, ics_, catalog, **kw):
        if z in sample_zs:
            catalogs[z] = _moved(catalog, "cpu")
        return perturb_catalog(z, inputs_, ics_, catalog, **kw)

    wrappers = {"cic_deposit_swept": deposit.cic_deposit_swept}
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    for name, attr in steps.items():
        setattr(rsds, attr, timed(name, originals[name]))
    xray_source.compute_xray_source_field = recorded_source
    halos.perturb_halo_catalog = recorded_catalog
    seconds, xh, tb, mini_means, samples, prev, lc = [], [], [], [], {}, None, None
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
            tb.append(cv.brightness_temp.double().mean().item())
            ion = cv.ionized_box
            if mini:
                mini_means.append((cv.spin_temp.J_21_LW.double().mean().item(),
                                   float(ion.log10_Mturnover_ave), float(ion.log10_Mturnover_MINI_ave)))
            if i in sample_at:
                samples[i] = dict(
                    z=z, pf=_moved(cv.perturbed_field, "cpu"), ts=_moved(cv.spin_temp, "cpu"),
                    ion=_moved(_without_stacks(ion), "cpu"), prev_ts=_moved(prev[0], "cpu"),
                    prev_ion=_moved(prev[1], "cpu"), prev_pf=_moved(prev[2], "cpu"), prev_z=prev[3],
                    halobox=_moved(cv.halobox, "cpu"), history=histories.pop(z, None),
                    catalog=catalogs.pop(z, None))
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
        halos.perturb_halo_catalog = perturb_catalog
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
    expected = len(nodes) + (setup_launches() if setup_launches else 0)
    if launches["cic_deposit_swept"] != expected:
        raise AssertionError(f"expected {expected} deposit launches in the {tag} lightcone, got {launches}")

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
    kept = {}
    if keep_tb_at is not None:
        lc_z = np.asarray(lc.lc_redshifts)
        n = so.HII_DIM
        start = int(np.clip(np.argmin(np.abs(lc_z - keep_tb_at)) - n // 2, 0, len(lc_z) - n))
        dist = np.asarray(lcr.lc_distances)
        kept = dict(tb_chunk=cone["brightness_temp"][:, :, start:start + n].clone(),
                    chunk_z=float(lc_z[start + n // 2]),
                    chunk_lens=(so.box_len, so.box_len, float(n * (dist[1] - dist[0]))))
    del lc, cone
    torch.cuda.empty_cache()
    for i in sample_at:
        s = {k: _moved(v, "cuda") if k not in ("z", "prev_z", "history") else v
             for k, v in samples.pop(i).items()}
        _node_stages(inputs, ics, s, f"{tag}-stages")
        del s
        torch.cuda.empty_cache()
    return dict(nodes=nodes, xh=xh, tb=tb, gxh=np.asarray(gxh), seconds=seconds, peak=peak, **kept)


def headline_phase(kernels, headline):
    """Phase 9: the headline lightcone from the ICs phase 3 computed; the
    stages of the node nearest z=8."""
    inputs, ics, ics_s = headline
    return lightcone_phase(kernels, inputs, ics, ics_s, "headline", "lightcone", (8.0,),
                           keep_tb_at=8.0)


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


# phase 12: the latest-discrete template at its 1.5 Mpc cell and DIM/HII_DIM = 3
# down the headline's ladder cut to z=8, in a 192 Mpc box (cut in volume: the
# catalogs of every node wait before the scroll, 2.4e9 halos and 64 GiB of
# host memory down to z=5, ~8x that at 384 Mpc; cut in depth to CUT_Z_END,
# which drops the chain's largest catalogs, to keep the script within its
# time once phase 16 joined it)
DISCRETE_BOX = dict(HII_DIM=128, DIM=384, BOX_LEN=192.0, Z_HEAT_MAX=35.0, ZPRIME_STEP_FACTOR=1.02,
                    MINIMIZE_MEMORY=True)
# the free host memory phases 12 and 14 need: cut to z=8, the waiting catalogs
# held 17.6 GiB (phase 12) and 20.7 GiB (phase 14's PARTITION chain) on an
# H100 host, and the process peaked at 27.3 GiB resident (down to z=5 phase 12
# had held 63.8 GiB, 70.1 GiB resident); checked before phase 1
DISCRETE_HOST_GIB = 40.0


def check_host_memory():
    """Fail at once, not after the earlier phases, when the host has less free
    memory than the waiting catalogs of phases 12 and 14 and the rest of the
    process need."""
    free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 2**30
    print(f"[host] {free:.3f} GiB of memory free; phases 12 and 14 need {DISCRETE_HOST_GIB} GiB")
    if free < DISCRETE_HOST_GIB:
        raise SystemExit(f"chip_smoke: {free:.1f} GiB of host memory free, phases 12 and 14 "
                         f"need {DISCRETE_HOST_GIB} GiB for the catalogs of their nodes")


def _octave_expectation(inputs, z, h, edges):
    """The conditional MF's expected count of the grid sampler's cells in each
    mass bin of `edges`: per cell the CMF integral above each edge, from
    the same delta axis and linear interpolation as its n_exp, summed over
    the cells that sample (n_exp > 0)."""
    from py21cmfast_torch.models import hmf
    from py21cmfast_torch.models.ionization import _get_sigma_table

    so, cosmo = inputs.simulation_options, inputs.cosmology
    sigma_table = _get_sigma_table(inputs)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    m_cell = cosmo.rho_mean * (so.box_len / so.HII_DIM) ** 3
    ln_mcell = np.log(m_cell)
    sigma_cell = float(sigma_table.sigma_of_lnm(ln_mcell))
    deltas = np.linspace(h["d_lo"], h["d_hi"], so.N_COND_INTERP)
    live = h["n_exp"] > 0
    above = [np.interp(h["delta_z"], deltas, hmf.nhalo_conditional(
        sigma_table, hmf_int, float(cosmo.dicke(z)), np.log(e), ln_mcell, sigma_cell, deltas)
        * m_cell)[live].sum() for e in edges]
    return -np.diff(above)


@contextlib.contextmanager
def _timed_chain():
    """Time generate_coeval's catalog chain while the block runs: one
    synchronised wall from the first catalog's start to the last one on the
    host, and by step (DexM, the grid sampler, the progenitors of each node,
    the moves between the card and the host), with the halo counts, the host
    bytes of the waiting catalogs, the lowest node's grid sample and its
    tables (`gate`), and the first progenitor step's descendant and
    progenitor masses (`first_step`).  Yields the record."""
    import torch

    from py21cmfast_torch import outputs
    from py21cmfast_torch.models import halos

    rec = dict(walls={"DexM": [], "grid sampler": [], "progenitors": [], "to card": [],
                      "to host": []},
               counts={}, host_bytes=[0], gate={}, chain_wall={}, first_step={})
    walls, gate, chain_wall = rec["walls"], rec["gate"], rec["chain_wall"]
    originals = {name: getattr(halos, name) for name in (
        "dexm_halo_grid", "sample_halo_grid", "grid_sampler_tables", "_sample_progenitors",
        "determine_halo_catalog")}
    catalog_to = outputs.HaloCatalog.to

    def timed(key, fn):
        def run(*a, **kw):
            out, t = _sync_time(lambda: fn(*a, **kw))
            walls[key].append(t)
            return out
        return run

    def tables(z, *a, **kw):
        gate["h"] = originals["grid_sampler_tables"](z, *a, **kw)
        gate["z"] = z
        return gate["h"]

    def sampled(*a, **kw):
        masses, pos = timed("grid sampler", originals["sample_halo_grid"])(*a, **kw)
        gate["masses"] = masses
        return masses, pos

    def progenitors(z, inputs_, prev_cat, *a, **kw):
        cat = timed("progenitors", originals["_sample_progenitors"])(z, inputs_, prev_cat, *a, **kw)
        if not rec["first_step"]:
            rec["first_step"].update(z_prev=float(prev_cat.redshift), z=z,
                                     desc=prev_cat.halo_masses.cpu(), prog=cat.halo_masses.cpu())
        return cat

    def determine(z, *a, **kw):
        if not chain_wall:
            torch.cuda.synchronize()
            chain_wall["start"] = time.perf_counter()
        cat = originals["determine_halo_catalog"](z, *a, **kw)
        rec["counts"][z] = cat.n_halos
        return cat

    def moved(self, device):
        out, t = _sync_time(lambda: catalog_to(self, device))
        if torch.device(device).type == "cpu":
            walls["to host"].append(t)
            chain_wall["end"] = time.perf_counter()
            rec["host_bytes"][0] += sum(v.numel() * v.element_size() for v in vars(out).values()
                                        if isinstance(v, torch.Tensor))
        else:
            walls["to card"].append(t)
        return out

    halos.dexm_halo_grid = timed("DexM", originals["dexm_halo_grid"])
    halos.sample_halo_grid = sampled
    halos.grid_sampler_tables = tables
    halos._sample_progenitors = progenitors
    halos.determine_halo_catalog = determine
    outputs.HaloCatalog.to = moved
    try:
        yield rec
    finally:
        for name, fn in originals.items():
            setattr(halos, name, fn)
        outputs.HaloCatalog.to = catalog_to


def _print_chain(tag, rec):
    """Print a `_timed_chain` record: the chain's wall and its parts, the
    halo counts and the host memory."""
    import resource

    walls, counts = rec["walls"], rec["counts"]
    zs = sorted(counts)
    z8 = min(zs, key=lambda z: abs(z - 8.0))
    prog = np.array(walls["progenitors"])
    parts = sum(sum(v) for k, v in walls.items() if k != "to card")
    wall = rec["chain_wall"]["end"] - rec["chain_wall"]["start"]
    print(f"[{tag}] catalog chain over {len(zs)} nodes: {wall:.2f} s wall before the "
          f"scroll, from the first catalog's start to the last one on the host; its timed parts "
          f"{parts:.2f} s, the host work between them {wall - parts:.2f} s; DexM {sum(walls['DexM']):.3f} s, grid sampler {sum(walls['grid sampler']):.3f} s, "
          f"progenitors {prog.sum():.2f} s ({len(prog)} steps: median {np.median(prog):.4f} s, max "
          f"{prog.max():.4f} s), card -> host {sum(walls['to host']):.2f} s; host -> card at the "
          f"nodes {sum(walls['to card']):.2f} s (median {np.median(walls['to card']):.4f} s)")
    print(f"[{tag}] halos at z={zs[0]}: {counts[zs[0]]}, at z={z8:.4f}: {counts[z8]}, at "
          f"z={zs[-1]:.3f}: {counts[zs[-1]]}; {sum(counts.values())} in all {len(zs)} catalogs, which "
          f"held {rec['host_bytes'][0] / 2**30:.3f} GiB of host memory while they waited; the process's "
          f"peak resident memory {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.3f} GiB")
    return wall, prog


def discrete_headline_phase(kernels):
    """Phase 12, the sixth main path: the latest-discrete lightcone
    (CHMF-SAMPLER, MASS-LIMITED progenitors, USE_TS_FLUCT, INHOMOGENEOUS)
    at 128^3 / 384^3 in 192 Mpc down the headline's ladder cut to
    CUT_Z_END (72 nodes), from the default CUDA generators, through
    lightcone_phase.  Its catalog chain is
    timed whole (one synchronised wall) and by step (DexM, the grid sampler,
    the progenitors of each node, the moves between the card and the host),
    with the halo counts and the host
    memory the waiting catalogs hold.  A statistical gate on the z=8 grid
    sample: its count within 1% of the expected sum(n_exp) (plus one halo
    per collapsed cell), and its count in each of 4 mass octaves from
    SAMPLER_MIN_MASS within 5 sigma of the conditional MF's expectation."""
    import torch

    import py21cmfast_torch as p21

    inputs = p21.InputParameters.from_template(
        DISCRETE_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**DISCRETE_BOX).with_logspaced_redshifts(CUT_Z_END)
    so = inputs.simulation_options
    if not inputs.matter_options.source_model_uses_halo_sampler:
        raise AssertionError(f"{DISCRETE_TEMPLATE} does not sample halos")
    ics, ics_s = _sync_time(lambda: p21.compute_initial_conditions(inputs))
    torch.cuda.empty_cache()

    with _timed_chain() as chain:
        lightcone_phase(kernels, inputs, ics, ics_s, "latest-discrete", "discrete_lightcone", (8.0,))
    _print_chain("latest-discrete", chain)

    # the statistical gate on the lowest node's grid sample (the collapsed
    # cells' halos last)
    gate = chain["gate"]
    h, masses = gate["h"], gate["masses"]
    n_coll = int(h["collapsed"].sum())
    sampled_m = masses[: masses.numel() - n_coll]
    n, n_exp = masses.numel(), h["n_expected"]
    edges = so.SAMPLER_MIN_MASS * 2.0 ** np.arange(5)
    got = torch.histc(torch.log2(sampled_m.double() / so.SAMPLER_MIN_MASS), bins=4, min=0,
                      max=4).cpu().numpy()
    expect = _octave_expectation(inputs, gate["z"], h, edges)
    sig = (got - expect) / np.sqrt(expect)
    print(f"[latest-discrete] z={gate['z']} grid sample: {n} halos against sum(n_exp) + collapsed "
          f"cells {n_exp:.1f} ({n / n_exp - 1:+.3e}, limit 1%); by mass octave from "
          f"{so.SAMPLER_MIN_MASS:.0e}: {got.astype(int).tolist()} against the CMF's "
          f"{np.round(expect, 1).tolist()}, ({np.round(sig, 3).tolist()}) sigma (limit 5)")
    if not (abs(n / n_exp - 1) <= 0.01 and np.all(np.abs(sig) <= 5.0)):
        raise AssertionError(f"the z={gate['z']} grid sample fails its statistical gate")


def photoncons_headline_phase(kernels, headline, base):
    """Phase 13: the headline lightcone under Z-PHOTONCONS, from the ICs
    phase 3 computed, launch counts zeroed just before and read just after:
    one deposit launch a node and one a calibration step.  The headline's
    box and ladder are cut to CUT_Z_END (72 of its 92 nodes, the slowest 20
    dropped), which keeps the script within its time since phase 16 joined
    it.  The calibration (its coevals, their z range and wall, the analytic
    history beside it), then <xH> and <Tb> at z=8 beside phase 9's (`base`)
    at its node nearest z=8, from the same seed and ICs."""
    import torch

    from py21cmfast_torch.drivers import coeval
    from py21cmfast_torch.models import photoncons
    from py21cmfast_torch.ops import deposit

    inputs, ics, _ = headline
    inputs = inputs.evolve_input_structs(PHOTON_CONS_TYPE="Z-PHOTONCONS").with_logspaced_redshifts(
        CUT_Z_END)
    setup, calibrate = coeval.setup_photon_cons, photoncons.calibrate_photon_cons
    rec = {}

    def timed_setup(inputs_, device="cuda"):
        state, rec["setup"] = _sync_time(lambda: setup(inputs_, device=device))
        return state

    def timed_calibration(*a, **kw):
        n0 = deposit.cic_deposit_swept.launches
        out, rec["calibration"] = _sync_time(lambda: calibrate(*a, **kw))
        rec["z_cal"], rec["launches"] = out[0], deposit.cic_deposit_swept.launches - n0
        return out

    coeval.setup_photon_cons = timed_setup
    photoncons.calibrate_photon_cons = timed_calibration
    try:
        run = lightcone_phase(kernels, inputs, ics, headline[2], "z-photoncons",
                              "photoncons_lightcone", (), setup_launches=lambda: len(rec["z_cal"]))
    finally:
        coeval.setup_photon_cons, photoncons.calibrate_photon_cons = setup, calibrate
    z_cal = rec["z_cal"]
    if rec["launches"] != len(z_cal):
        raise AssertionError(f"the calibration launched the deposit {rec['launches']} times in "
                             f"{len(z_cal)} steps")
    state = setup(inputs)
    later = np.array(run["seconds"][1:])
    print(f"[z-photoncons] setup {rec['setup']:.2f} s on the first node: the calibration's "
          f"{len(z_cal)} coevals (256^3 from 768^3 ICs of their own) z {z_cal[0]:.3f} -> "
          f"{z_cal[-1]:.3f} in {rec['calibration']:.2f} s, the analytic history and deltaz the "
          f"rest; then median {np.median(later):.4f} s a node (spread {later.min():.4f} - "
          f"{later.max():.4f}); peak memory {run['peak']:.3f} GiB")
    zi, j = run["nodes"][-1], int(np.argmin(np.abs(np.asarray(base["nodes"]) - CUT_Z_END)))
    print(f"[z-photoncons] {len(run['nodes'])} nodes to z={zi:.4f} (computed at "
          f"z={state.adjusted_redshift(zi):.4f}): <xH> {run['xh'][-1]:.6f}, <Tb> {run['tb'][-1]:.5f} "
          f"mK; without the correction (phase 9, z={base['nodes'][j]:.4f}) <xH> "
          f"{base['xh'][j]:.6f}, <Tb> {base['tb'][j]:.5f} mK")
    if not (state.adjusted_redshift(8.0) < 8.0 and zi == CUT_Z_END):
        raise AssertionError("Z-PHOTONCONS shifted no node of the headline lightcone")
    torch.cuda.empty_cache()


# phase 16: the command line on the headline's settings (bench.py:73-91),
# its ladder cut to z=10 (61 nodes)
CLI_Z_END = 10.0
CLI_ARGS = ["run", "lightcone", "--seed", str(HEADLINE_SEED), "--min-z", str(CLI_Z_END),
            "--max-z", "35"] + [a for kv in (
                "HII_DIM=256", "DIM=768", "BOX_LEN=384", "SOURCE_MODEL=E-INTEGRAL",
                "USE_TS_FLUCT=true", "RECOMB_MODEL=inhomogeneous", "R_BUBBLE_MAX=50",
                "USE_EXP_FILTER=false", "CELL_RECOMB=false", "Z_HEAT_MAX=35",
                "ZPRIME_STEP_FACTOR=1.02", "MINIMIZE_MEMORY=true") for a in ("-p", kv)]
# card against CPU, of each value: the power spectrum's bins and the halo
# properties (float32 FFTs and transcendentals of two libraries)
PS_REL = 1e-5
HALO_PROPS_REL = 1e-5
HALO_PROPS_N = 10_000_000


def _cli_subprocesses(commands):
    """`python -m py21cmfast_torch <args>` for each of `commands`, each in a
    process of its own, all started together from the checkout's root: for
    each its exit code, its output and its errors, and the wall of all."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "py21cmfast_torch", *args],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for args in commands]
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        outs.append((proc.returncode, out, err))
    return outs, time.perf_counter() - t0


def cli_phase(kernels, base):
    """Phase 16: the command line and the surroundings of the port.
    `python -m py21cmfast_torch template avail` and `run params` in
    subprocesses of their own, run together (this machine has no h5py and no matplotlib,
    which the package imports only where a command needs them); then
    `cli.main` runs the headline lightcone to z=10 in this process, launch
    counts zeroed just before and read just after (one deposit launch a
    node); then on phase 9's cone (`base`): the power spectrum of its z~8
    chunk on the card against the CPU, and the Thomson optical depth of its
    global xH history; then the halo properties of HALO_PROPS_N log-uniform
    masses on the card against the CPU, from draws made on the CPU."""
    import contextlib
    import io

    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch import cfuncs, cli
    from py21cmfast_torch.ops import deposit, ps

    commands = (["template", "avail"], ["run", "params", "--template", "latest"])
    outs, wall = _cli_subprocesses(commands)
    print(f"[cli] {len(commands)} subprocesses of python -m py21cmfast_torch, run together: "
          f"{wall:.2f} s")
    for args, (code, out, err) in zip(commands, outs):
        lines = out.splitlines()
        print(f"[cli] python -m py21cmfast_torch {' '.join(args)}: exit {code}, {len(lines)} "
              f"lines, first {lines[0] if lines else ''!r}")
        if code != 0 or not lines:
            raise AssertionError(f"python -m py21cmfast_torch {' '.join(args)} failed:\n{out}{err}")

    wrappers = {"cic_deposit_swept": deposit.cic_deposit_swept}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        lc = cli.main(CLI_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    line = [ln for ln in out.getvalue().splitlines() if ln.startswith("lightcone:")][-1]
    nodes = lc.node_redshifts
    print(f"[cli] 21cmfast-torch {' '.join(CLI_ARGS)}")
    print(f"[cli] its output: {line}")
    print(f"[cli] {len(nodes)} nodes {nodes[0]:.3f} -> {nodes[-1]:.3f} in {wall:.2f} s on the card "
          f"(ICs, scroll and finalization; {wall / len(nodes):.3f} s a node in all); launches "
          f"{launches}; peak memory {peak:.3f} GiB")
    for k in kernels:
        k["launches_by_path"]["cli_lightcone"] = launches[k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
        if launches[k["name"]] < 1:
            raise AssertionError(f"the command line's lightcone never launched {k['name']}")
    lo, hi = (float(v) for v in line.split("Tb range [")[1].split("]")[0].split(","))
    bt = lc.brightness_temp
    if not (len(nodes) == 61 and launches["cic_deposit_swept"] == len(nodes)):
        raise AssertionError(f"expected 61 nodes and as many deposit launches: {len(nodes)}, {launches}")
    if not (line.startswith("lightcone: shape=(256, 256, ") and np.isfinite([lo, hi]).all() and lo < hi
            and bt.is_cuda and bool(torch.isfinite(bt).all())):
        raise AssertionError(f"the command line's lightcone is not a finite 256^2 cone: {line}")
    del lc, bt
    torch.cuda.empty_cache()

    chunk, lens = base["tb_chunk"], base["chunk_lens"]
    (k_g, p_g, n_g), t_g = _sync_time(lambda: ps.power_spectrum_1d(chunk, lens))
    cpu_chunk = chunk.cpu()
    (k_c, p_c, n_c), t_c = _sync_time(lambda: ps.power_spectrum_1d(cpu_chunk, lens))
    good = np.isfinite(p_c) & (n_c > 0)
    rel = np.abs(p_g[good] - p_c[good]) / np.abs(p_c[good])
    print(f"[cli] P(k) of phase 9's Tb cone, {tuple(chunk.shape)} slices centred at "
          f"z={base['chunk_z']:.3f} ({lens[2]:.1f} Mpc along the line of sight), 16 log bins: "
          f"{t_g * 1e3:.2f} ms on the card, {t_c * 1e3:.2f} ms on the CPU; max rel diff "
          f"{rel.max():.3e} (limit {PS_REL:.0e}); P {np.round(p_g[good], 4).tolist()} mK^2 Mpc^3 at "
          f"k {np.round(k_g[good], 4).tolist()} /Mpc")
    if not (good.sum() >= 8 and np.array_equal(n_g, n_c) and np.allclose(k_g[good], k_c[good], rtol=1e-12)
            and np.all(rel <= PS_REL)):
        raise AssertionError("the power spectrum on the card disagrees with the CPU's")

    inputs = _headline_inputs()
    tau = cfuncs.compute_tau(inputs, base["nodes"], base["gxh"])
    print(f"[cli] compute_tau of phase 9's global xH, {len(base['nodes'])} nodes z "
          f"{base['nodes'][0]:.3f} -> {base['nodes'][-1]:.3f} (xH {base['gxh'][0]:.4f} -> "
          f"{base['gxh'][-1]:.4f}): tau_e = {tau:.6f}")
    if not 0.0 < tau < 0.2:
        raise AssertionError(f"tau_e = {tau} is out of range")

    disc = p21.InputParameters.from_template(DISCRETE_TEMPLATE, random_seed=HEADLINE_SEED)
    rng = np.random.default_rng(HEADLINE_SEED)
    masses = np.exp(rng.uniform(np.log(1e8), np.log(1e12), HALO_PROPS_N)).astype(np.float32)
    rngs = rng.standard_normal((3, HALO_PROPS_N)).astype(np.float32)
    props_g, t_g = _sync_time(lambda: cfuncs.convert_halo_properties(disc, 8.0, masses, *rngs))
    props_c, t_c = _sync_time(
        lambda: cfuncs.convert_halo_properties(disc, 8.0, masses, *rngs, device="cpu"))
    errs = {}
    for name, c in props_c.items():
        g = props_g[name]
        scale = np.maximum(np.abs(c), np.finfo(np.float32).tiny)
        errs[name] = float(np.max(np.abs(g.astype(np.float64) - c) / scale))
    print(f"[cli] convert_halo_properties of {HALO_PROPS_N:.0e} masses 1e8-1e12 Msun at z=8 "
          f"({DISCRETE_TEMPLATE}): {t_g * 1e3:.1f} ms on the card (with the copies), "
          f"{t_c * 1e3:.1f} ms on the CPU; max rel diff per property "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (limit {HALO_PROPS_REL:.0e})")
    if not all(np.isfinite(props_g[k]).all() for k in props_g) or max(errs.values()) > HALO_PROPS_REL:
        raise AssertionError("the halo properties on the card disagree with the CPU's")
    torch.cuda.empty_cache()


# phase 14: the PARTITION and BINARY-SPLIT progenitor samplers at phase 12's
# box, the latest-discrete template (HMF 'ST') down the headline's ladder cut
# to z=10 (the catalogs of every node wait on the host): to z=8 until phase
# 17 joined the script, which the cut makes room for
SAMPLERS_Z_END = 10.0
# the octave tolerances of tests/test_sampler_methods.py:143
SAMPLER_OCTAVE_TOL = {"PARTITION": 0.75, "BINARY-SPLIT": 0.85}


def _progenitor_octaves(inputs, step, edges):
    """The first progenitor step's counts by mass bin of `edges` and the
    conditional MF's expectation: per descendant the CMF integral over the
    bin (below its own mass), conditioned as the sampler conditions it,
    summed over the descendants in 256 log bins of their mass."""
    from py21cmfast_torch.models import hmf
    from py21cmfast_torch.models.ionization import _get_sigma_table

    cosmo = inputs.cosmology
    table = _get_sigma_table(inputs)
    hmf_i = hmf.HMF_NAMES[inputs.matter_options.HMF]
    eff = hmf_i if hmf_i in (0, 1, 4) else 0
    growth, growth_prev = float(cosmo.dicke(step["z"])), float(cosmo.dicke(step["z_prev"]))
    desc = step["desc"].double().numpy()
    counts, bin_edges = np.histogram(np.log(desc), bins=256)
    live = counts > 0
    ln_m = 0.5 * (bin_edges[1:] + bin_edges[:-1])[live]
    sig = table.sigma_of_lnm(ln_m)
    delta = hmf.get_delta_crit(eff, sig, growth_prev) * growth / growth_prev
    expect = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        ln_hi = np.minimum(np.log(hi), ln_m)
        per = hmf.integrate_cmf(table, hmf_i, growth, np.log(lo), np.maximum(ln_hi, np.log(lo)),
                                delta, sig) * np.exp(ln_m)
        expect.append(float((np.where(ln_hi > np.log(lo), per, 0.0) * counts[live]).sum()))
    got = np.histogram(step["prog"].double().numpy(), bins=edges)[0]
    return got, np.array(expect)


def samplers_headline_phase(kernels):
    """Phase 14: generate_coeval of the latest-discrete template at phase
    12's box down the headline's ladder to SAMPLERS_Z_END, once with PARTITION and once
    with BINARY-SPLIT progenitors, from the default CUDA generators, launch
    counts zeroed just before and read just after (one deposit launch a
    node).  Each: the catalog chain's wall and its parts (`_timed_chain`),
    the halo count at SAMPLERS_Z_END, the seconds a node, and a gate on the
    first progenitor step (from SAMPLERS_Z_END to the next node): its count
    in each of 4 mass
    octaves from SAMPLER_MIN_MASS within SAMPLER_OCTAVE_TOL of the
    conditional MF's expectation (`_progenitor_octaves`); for the binary
    split the rows that spilled past its 256 progenitors and the branches
    force-saved at its last step."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import halos
    from py21cmfast_torch.ops import deposit

    base = p21.InputParameters.from_template(
        DISCRETE_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**DISCRETE_BOX).with_logspaced_redshifts(SAMPLERS_Z_END)
    ics, ics_s = _sync_time(lambda: p21.compute_initial_conditions(base))
    for method in ("PARTITION", "BINARY-SPLIT"):
        tag = method.lower()
        inputs = base.evolve_input_structs(SAMPLE_METHOD=method)
        so, nodes = inputs.simulation_options, list(inputs.node_redshifts)
        split = {"spilled": 0, "forced": 0}
        kernel = halos._binary_split_kernel

        def counted(*a, **kw):
            out = kernel(*a, **kw)
            split["spilled"] += int((out[3] > kw["cap_out"]).sum())
            split["forced"] += out[4]
            return out

        halos._binary_split_kernel = counted
        deposit.cic_deposit_swept.launches = 0
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        try:
            with _timed_chain() as chain:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for cv in p21.generate_coeval(inputs, initial_conditions=ics):
                    torch.cuda.synchronize()
                    seconds.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    last = cv
        finally:
            halos._binary_split_kernel = kernel
        launches = deposit.cic_deposit_swept.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        if len(seconds) != len(nodes) or abs(last.redshift - SAMPLERS_Z_END) > 1e-6:
            raise AssertionError(f"{method}: {len(seconds)} nodes yielded of {len(nodes)}")
        _check_fields(last.redshift, so.lowres_shape, last.perturbed_field, last.halobox,
                      last.spin_temp, last.ionized_box, last.brightness_temperature)
        for k in kernels:
            k["launches_by_path"][f"{tag}_coeval"] = launches
            k["launches"] = sum(k["launches_by_path"].values())
        if launches != len(nodes):
            raise AssertionError(f"{method}: {launches} deposit launches in {len(nodes)} nodes")
        wall, prog = _print_chain(tag, chain)
        later = np.array(seconds[1:])
        print(f"[{tag}] {len(nodes)} nodes {nodes[0]:.3f} -> {nodes[-1]:.3f} in {sum(seconds):.2f} s "
              f"(the first with the chain {seconds[0]:.2f} s), then median {np.median(later):.4f} s a "
              f"node (min {later.min():.4f}, max {later.max():.4f}); <xH> at z={last.redshift:.3f} "
              f"{last.neutral_fraction.double().mean().item():.6f}; launches {launches}; peak "
              f"memory {peak:.3f} GiB; ICs {ics_s:.3f} s")
        if method == "BINARY-SPLIT":
            print(f"[{tag}] rows past 256 progenitors (their extra progenitors lost, as in the "
                  f"JAX package): {split['spilled']}; branches force-saved after 48 steps: "
                  f"{split['forced']}")
        step = chain["first_step"]
        edges = so.SAMPLER_MIN_MASS * 2.0 ** np.arange(5)
        got, expect = _progenitor_octaves(inputs, step, edges)
        ratio = got / expect
        tol = SAMPLER_OCTAVE_TOL[method]
        print(f"[{tag}] first progenitor step z={step['z_prev']:.4f} -> {step['z']:.4f}: "
              f"{step['desc'].numel()} descendants, {step['prog'].numel()} progenitors; by mass "
              f"octave from {so.SAMPLER_MIN_MASS:.0e}: {got.tolist()} against the CMF's "
              f"{np.round(expect, 1).tolist()} (ratio {np.round(ratio, 4).tolist()}, limit 1 +- {tol})")
        if not (np.all(expect >= 200) and np.all(np.abs(ratio - 1) < tol)):
            raise AssertionError(f"{method}: the first progenitor step fails its octave gate")
        del chain, last, step
        torch.cuda.empty_cache()


# the 0-D history's card-vs-CPU bound, a share of the value plus a share of
# the series' largest magnitude: the float32 1-cell Ts chain over 92 nodes
# differs by up to 2e-4 of its value, and Tb crosses zero
GLOBAL_REL, GLOBAL_ABS = 1e-3, 1e-4


def _global_on_cpu(inputs, path):
    """The 0-D history on the CPU, in a process of its own (one torch
    thread, beside the card's phases), written to `path`."""
    import pickle

    import torch

    import py21cmfast_torch as p21

    torch.set_num_threads(1)

    t0 = time.perf_counter()
    ge = p21.run_global_evolution(inputs, device="cpu")
    with open(path, "wb") as fh:
        pickle.dump((ge.quantities, time.perf_counter() - t0), fh)


def start_global_on_cpu():
    """Phase 15's CPU run of the 0-D history on the headline's inputs,
    started in a process of its own at the beginning, beside the card's
    phases; `global_phase` collects it."""
    import multiprocessing
    import tempfile

    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_", dir="."), "global_cpu.pkl")
    proc = multiprocessing.get_context("spawn").Process(
        target=_global_on_cpu, args=(_headline_inputs(), path))
    proc.start()
    return proc, path


def global_phase(cpu_run):
    """Phase 15: run_global_evolution on the headline's inputs on the card,
    against the same on the CPU (run beside the card's phases): every
    quantity per node within GLOBAL_REL of its value plus GLOBAL_ABS of the
    series' largest magnitude; the wall of each."""
    import pickle
    import shutil

    import py21cmfast_torch as p21

    inputs = _headline_inputs()
    ge, wall = _sync_time(lambda: p21.run_global_evolution(inputs))
    proc, path = cpu_run
    proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"the CPU run of the 0-D history failed (exit code {proc.exitcode})")
    with open(path, "rb") as fh:
        quantities, cpu_wall = pickle.load(fh)
    shutil.rmtree(os.path.dirname(path))
    ok = sorted(quantities) == sorted(ge.quantities)
    errs = {}
    z = ge.node_redshifts
    for name, c in quantities.items():
        c, g = np.asarray(c, np.float64), np.asarray(ge.quantities[name], np.float64)
        err = np.abs(g - c)
        rel = err / np.maximum(np.abs(c), 1e-300)
        errs[name] = (float(rel.max()), float(z[np.argmax(rel)]),
                      float(err.max() / max(np.abs(c).max(), 1e-300)))
        ok &= bool(np.all(err <= GLOBAL_REL * np.abs(c) + GLOBAL_ABS * np.abs(c).max()))
    i8 = int(np.argmin(np.abs(z - 8.0)))
    print(f"[global] run_global_evolution on the headline's inputs, {len(z)} nodes {z[0]:.3f} -> "
          f"{z[-1]:.3f}: {wall:.2f} s on the card, {cpu_wall:.2f} s on the CPU; xH "
          f"{ge.quantities['neutral_fraction'][i8]:.6f} and Tb {ge.quantities['brightness_temp'][i8]:.4f} "
          f"mK at z={z[i8]:.4f}; (max rel, at z, max err / max) per quantity "
          f"{{{', '.join(f'{k}: ({v[0]:.2e}, {v[1]:.3f}, {v[2]:.2e})' for k, v in errs.items())}}} "
          f"(limit {GLOBAL_REL:.0e} of the value plus {GLOBAL_ABS:.0e} of the largest)")
    if not ok:
        raise AssertionError("the 0-D history on the card disagrees with the CPU run")


# ---------------------------------------------------------------------------
# phase 17: the sharded paths of py21cmfast_torch.parallel on the card.  The
# card host has one GPU, so 17a runs NCCL with one rank in this process and
# 17b-17d run two ranks on the one card with gloo, whose collectives go
# through host memory: their times are not multi-GPU scaling numbers.

SHARDED_TIMEOUT = 420.0  # seconds for the ranks of one sharded run
# the headline's box (bench.py:73-91) at z=8 with a saturated Ts: 17b
SHARDED_HEADLINE = dict(HII_DIM=256, DIM=768, BOX_LEN=384.0, SOURCE_MODEL="E-INTEGRAL",
                        PERTURB_ALGORITHM="2LPT", R_BUBBLE_MAX=50.0, USE_EXP_FILTER=False)
# the headline's physics (USE_TS_FLUCT, INHOMOGENEOUS) at 128^3 / 384^3 in
# 192 Mpc (its 1.5 Mpc cell), 9 nodes from Z_HEAT_MAX=35 to z=8: 17c
SHARDED_LC = dict(HII_DIM=128, DIM=384, BOX_LEN=192.0, Z_HEAT_MAX=35.0, ZPRIME_STEP_FACTOR=1.19,
                  SOURCE_MODEL="E-INTEGRAL", USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS",
                  R_BUBBLE_MAX=50.0, USE_EXP_FILTER=False, CELL_RECOMB=False)
SHARDED_LC_Z_END = 8.0
# 17c's Ts and Tb bound, a share of the field's maximum: float32 chains of 9
# Ts nodes through two FFT decompositions (the slab FFT and cuFFT's 3D one),
# as phase 4c bounds the card's chains against the CPU's (1e-3); the
# single snapshots of 17a and 17b keep 1e-4
SHARDED_CHAIN_TOL = 1e-3
# the latest-discrete template at 64^3 / 192^3 in 96 Mpc (its 1.5 Mpc cell)
# to z=10, its ladder cut to ZPRIME_STEP_FACTOR=1.1: 17d
SHARDED_DISCRETE = dict(HII_DIM=64, DIM=192, BOX_LEN=96.0, Z_HEAT_MAX=35.0, ZPRIME_STEP_FACTOR=1.1)
SHARDED_DISCRETE_Z = 10.0


def _coeval_gates(tag, z, got, ref, tol=1e-4):
    """The gates of tests/test_parallel.py:97-100 on one node (density RMS,
    <xH>, rounded xH) plus Ts and Tb within `tol` of their maximum (Tb where
    xH agrees): returns the numbers and whether every gate holds.  `got`
    and `ref` map field names to float64 numpy arrays."""
    d_s, d_1 = got["density"], ref["density"]
    x_s, x_1 = got["xH"], ref["xH"]
    rms = float(np.sqrt(np.mean((d_s - d_1) ** 2)))
    same = np.abs(x_s - x_1) <= 1e-5
    out = dict(z=z, density_rms_over_sigma=rms / float(d_1.std()),
               xH=(float(x_s.mean()), float(x_1.mean())),
               rounded_xH_flips=float(np.mean(np.round(x_s, 3) != np.round(x_1, 3))),
               Tb_max_err_over_max=float(np.abs(got["Tb"] - ref["Tb"])[same].max()
                                         / np.abs(ref["Tb"]).max()))
    ok = (rms < 1e-4 * d_1.std() + 1e-6 and abs(out["xH"][0] - out["xH"][1]) < 1e-3
          and out["rounded_xH_flips"] < 5e-3 and out["Tb_max_err_over_max"] <= tol)
    if "Ts" in ref:
        out["Ts_max_err_over_max"] = float(np.abs(got["Ts"] - ref["Ts"]).max()
                                           / np.abs(ref["Ts"]).max())
        ok = ok and out["Ts_max_err_over_max"] <= tol
    print(f"[{tag}] z={z:.3f}: density RMS {out['density_rms_over_sigma']:.3e} sigma (limit "
          f"1e-4), <xH> {out['xH'][0]:.6f} against {out['xH'][1]:.6f}, rounded xH differs in "
          f"{out['rounded_xH_flips']:.2e} of the cells (limit 5e-3), Tb max-abs "
          f"{out['Tb_max_err_over_max']:.2e} of max|Tb| where xH agrees"
          + (f", Ts max-abs {out['Ts_max_err_over_max']:.2e} of its max" if "Ts" in ref else "")
          + f" (limit {tol:.0e})")
    return out, ok


def _host(t):
    return None if t is None else t.detach().double().cpu().numpy()


def _node_fields(cv):
    ts = getattr(cv, "spin_temp", None)
    fields = dict(density=cv.perturbed_field.density, xH=cv.ionized_box.neutral_fraction,
                  Tb=cv.brightness_temperature.brightness_temp)
    if ts is not None:
        fields["Ts"] = ts.spin_temperature
    return fields


@contextlib.contextmanager
def _timed_parts(walls):
    """Synchronised walls of the sharded coeval's parts (ICs, perturb, Ts,
    ionize, Tb) added into `walls`, and of the slab CIC's scatters
    ("slab CIC": the perturb deposit's, and with halos the painting's)."""
    import torch

    from py21cmfast_torch.models import brightness, ionization, spintemp
    from py21cmfast_torch.parallel import driver, perturb

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            walls[key] = walls.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    saved = [(driver, "_sharded_ics"), (driver, "build_sharded_perturb"),
             (ionization, "compute_ionization_field"), (spintemp, "compute_spin_temperature"),
             (brightness, "brightness_temperature"), (perturb, "_cic_scatter_buffer")]
    originals = [getattr(m, n) for m, n in saved]
    build = driver.build_sharded_perturb
    driver._sharded_ics = timed("ICs", driver._sharded_ics)
    driver.build_sharded_perturb = lambda *a, **kw: timed("perturb", build(*a, **kw))
    ionization.compute_ionization_field = timed("ionize", ionization.compute_ionization_field)
    spintemp.compute_spin_temperature = timed("Ts", spintemp.compute_spin_temperature)
    brightness.brightness_temperature = timed("Tb", brightness.brightness_temperature)
    perturb._cic_scatter_buffer = timed("slab CIC", perturb._cic_scatter_buffer)
    try:
        yield walls
    finally:
        for (m, n), f in zip(saved, originals):
            setattr(m, n, f)


def _rank_report(mesh, walls, wall, launches):
    import torch

    return dict(rank=mesh.rank, wall=wall, parts=dict(walls), launches=launches,
                collective_s=mesh.stats["seconds"], collective_calls=mesh.stats["calls"],
                collective_gib=mesh.stats["bytes"] / 2**30,
                host_copy_gib=mesh.stats["host_bytes"] / 2**30,
                peak_gib=torch.cuda.max_memory_allocated(mesh.device) / 2**30)


def _sharded_headline_job(mesh):
    """17b / 17e on one rank: run_sharded_coeval of the headline's box at
    z=8, timed by part; rank 0 then runs the single-device run_coeval of the
    same seed (the 2LPT source of the whole box, as the sharded ICs take
    it: the single-device ICs truncate it above 640^3 cells) and compares."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import ics as ics_module
    from py21cmfast_torch.ops import deposit
    from py21cmfast_torch.parallel.driver import run_sharded_coeval
    from py21cmfast_torch.parallel.mesh import gather_slabs

    inputs = p21.InputParameters(random_seed=HEADLINE_SEED).evolve_input_structs(
        **SHARDED_HEADLINE)
    mesh.timed = True
    deposit.cic_deposit_swept.launches = 0
    torch.cuda.reset_peak_memory_stats(mesh.device)
    walls = {}
    with _timed_parts(walls):
        (out,), wall = _sync_time(lambda: run_sharded_coeval(inputs, [8.0], mesh=mesh))
    report = _rank_report(mesh, walls, wall, deposit.cic_deposit_swept.launches)
    got = {k: _host(gather_slabs(mesh, v)) for k, v in _node_fields(out).items()}
    del out
    if mesh.rank == 0:
        torch.cuda.empty_cache()
        ics_module._2LPT_MAX_INHBM_CELLS = float("inf")
        (cv,), single_s = _sync_time(lambda: p21.run_coeval(inputs, [8.0], device=mesh.device))
        report["single_wall"] = single_s
        report["gates"] = _coeval_gates("sharded-headline", 8.0, got,
                                        {k: _host(v) for k, v in _node_fields(cv).items()})
    mesh.barrier()
    return report


def _sharded_lightcone_job(mesh):
    """17c on one rank: run_sharded_lightcone of SHARDED_LC, every node's
    fields gathered; rank 0 then runs generate_lightcone of the same seed on
    one device and compares per node and per cone."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.ops import deposit
    from py21cmfast_torch.parallel import driver
    from py21cmfast_torch.parallel.mesh import gather_slabs

    inputs = p21.InputParameters(random_seed=HEADLINE_SEED).evolve_input_structs(
        **SHARDED_LC).with_logspaced_redshifts(SHARDED_LC_Z_END)
    mesh.timed = True
    deposit.cic_deposit_swept.launches = 0
    torch.cuda.reset_peak_memory_stats(mesh.device)
    nodes = []
    scroll = driver.run_sharded_coeval

    def kept(*a, **kw):
        out = scroll(*a, **kw)
        for o in out:
            nodes.append({k: _host(gather_slabs(mesh, v)) for k, v in _node_fields(o).items()})
        return out

    walls = {}
    driver.run_sharded_coeval = kept
    try:
        with _timed_parts(walls):
            lc, wall = _sync_time(lambda: driver.run_sharded_lightcone(inputs, mesh=mesh))
    finally:
        driver.run_sharded_coeval = scroll
    report = _rank_report(mesh, walls, wall, deposit.cic_deposit_swept.launches)
    if mesh.rank == 0:
        ref_nodes = []
        ref = None
        t0 = time.perf_counter()
        for z, cv, lc_1 in p21.generate_lightcone(inputs, device=mesh.device):
            if cv is not None:
                ref_nodes.append({k: _host(v) for k, v in _node_fields(cv).items()})
            ref = lc_1
        torch.cuda.synchronize()
        report["single_wall"] = time.perf_counter() - t0
        gates, ok = [], len(nodes) == len(ref_nodes) == len(inputs.node_redshifts)
        for z, g, r in zip(inputs.node_redshifts, nodes, ref_nodes):
            numbers, node_ok = _coeval_gates("sharded-lightcone", float(z), g, r,
                                             tol=SHARDED_CHAIN_TOL)
            gates.append(numbers)
            ok = ok and node_ok
        cones = {}
        for q, cone in ref.lightcones.items():
            r, g = _host(cone), _host(lc.lightcones[q])
            cones[q] = float(np.mean(np.abs(g - r) > 1e-3 * np.abs(r).max()))
            ok = ok and g.shape == r.shape and cones[q] <= 1e-3
        report["gates"] = (dict(nodes=gates, cones_off_share=cones), ok)
        print(f"[sharded-lightcone] share of each cone's cells off by > 1e-3 of its max: {cones} "
              "(limit 1e-3)")
    mesh.barrier()
    return report


def _sharded_discrete_job(mesh):
    """17d on one rank: run_sharded_coeval of the latest-discrete template
    at SHARDED_DISCRETE to z=10, with the grid sample of each slab recorded
    (its count and mass octaves against the expected, summed over the
    ranks), and the last node's sharded HaloBox against the single-device
    compute_halo_grid of the same perturbed catalog."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import halobox, halos
    from py21cmfast_torch.ops import deposit
    from py21cmfast_torch.parallel import halopaint
    from py21cmfast_torch.parallel.driver import run_sharded_coeval
    from py21cmfast_torch.parallel.mesh import gather_slabs

    inputs = p21.InputParameters.from_template(
        DISCRETE_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**SHARDED_DISCRETE).with_logspaced_redshifts(SHARDED_DISCRETE_Z)
    so = inputs.simulation_options
    mesh.timed = True
    deposit.cic_deposit_swept.launches = 0
    torch.cuda.reset_peak_memory_stats(mesh.device)
    sample, painted = {}, {}
    tables, sampler, paint = halos.grid_sampler_tables, halos.sample_halo_grid, \
        halopaint.sharded_halo_grids

    def tables_kept(z, *a, **kw):
        sample["h"], sample["z"] = tables(z, *a, **kw), z
        return sample["h"]

    def sampler_kept(*a, **kw):
        masses, pos = sampler(*a, **kw)
        sample["masses"] = masses
        return masses, pos

    def paint_kept(z, inputs_, pt_halos, mesh_, **kw):
        out = paint(z, inputs_, pt_halos, mesh_, **kw)
        # copies: the driver adds the sub-sampler grids to the namespace
        painted.update(z=z, pt=pt_halos, grids={k: getattr(out, k).clone() for k in (
            "n_ion", "halo_sfr", "whalo_sfr", "halo_xray")})
        return out

    halos.grid_sampler_tables, halos.sample_halo_grid = tables_kept, sampler_kept
    halopaint.sharded_halo_grids = paint_kept
    walls = {}
    try:
        with _timed_parts(walls):
            (out,), wall = _sync_time(lambda: run_sharded_coeval(inputs, [SHARDED_DISCRETE_Z],
                                                                 mesh=mesh))
    finally:
        halos.grid_sampler_tables, halos.sample_halo_grid = tables, sampler
        halopaint.sharded_halo_grids = paint
    report = _rank_report(mesh, walls, wall, deposit.cic_deposit_swept.launches)
    h, masses = sample["h"], sample["masses"]
    n_coll = int(h["collapsed"].sum())
    edges = so.SAMPLER_MIN_MASS * 2.0 ** np.arange(5)
    got = torch.histc(torch.log2(masses[: masses.numel() - n_coll].double() / so.SAMPLER_MIN_MASS),
                      bins=4, min=0, max=4).cpu().numpy()
    expect = _octave_expectation(inputs, sample["z"], h, edges)
    sums = mesh.all_reduce_floats([masses.numel(), h["n_expected"]] + got.tolist()
                                  + expect.tolist())
    n, n_exp = sums[0], sums[1]
    got_all, expect_all = np.array(sums[2:6]), np.array(sums[6:10])
    grids = {k: _host(gather_slabs(mesh, v)) for k, v in painted["grids"].items()}
    fields = {k: _host(gather_slabs(mesh, v)) for k, v in _node_fields(out).items()}
    if mesh.rank == 0:
        sig = (got_all - expect_all) / np.sqrt(expect_all)
        single, report["single_wall"] = _sync_time(lambda: halobox.compute_halo_grid(
            painted["z"], inputs, painted["pt"], device=mesh.device))
        errs = {k: float(np.abs(v - _host(getattr(single, k))).max()
                         / np.abs(_host(getattr(single, k))).max()) for k, v in grids.items()}
        ok = (abs(n / n_exp - 1) <= 0.01 and bool(np.all(np.abs(sig) <= 5.0))
              and all(e <= 1e-5 for e in errs.values())
              and all(np.isfinite(v).all() for v in fields.values()))
        print(f"[sharded-discrete] z={sample['z']} slab grid samples of {mesh.size} ranks: "
              f"{int(n)} halos against sum(n_exp) + collapsed cells {n_exp:.1f} "
              f"({n / n_exp - 1:+.3e}, limit 1%); by mass octave from {so.SAMPLER_MIN_MASS:.0e}: "
              f"{got_all.astype(int).tolist()} against the CMF's {np.round(expect_all, 1).tolist()} "
              f"({np.round(sig, 3).tolist()} sigma, limit 5); sharded_halo_grids of the "
              f"z={painted['z']:.3f} catalog ({painted['pt'].n_halos} halos) against "
              f"compute_halo_grid, max-abs over max: {errs} (limit 1e-5); <xH> "
              f"{fields['xH'].mean():.6f}")
        report["gates"] = (dict(count=(n, n_exp), octave_sigma=sig.tolist(), grids=errs), ok)
    mesh.barrier()
    return report


def _sharded_rank(rank, world, store_dir, backend, job, out_path):
    """One rank of a sharded phase: join the group, run `job`, write the
    report (or the traceback) to `out_path` + rank."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    result = None
    try:
        device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
        torch.cuda.set_device(device)
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                                              world),
                                rank=rank, world_size=world)
        from py21cmfast_torch.parallel.mesh import make_mesh

        mesh = make_mesh(world, backend=backend, device=device)
        result = ("ok", globals()[job](mesh))
    except Exception:
        result = ("error", traceback.format_exc())
    finally:
        with open(f"{out_path}{rank}", "wb") as fh:
            pickle.dump(result, fh)
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_sharded(tag, job, world=2, backend="gloo"):
    """Run `job` on `world` spawned ranks (two on the one card by default,
    gloo); every rank is joined under SHARDED_TIMEOUT and then stopped.
    Returns the ranks' reports; raises when a rank failed or hung."""
    import multiprocessing
    import pickle
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_", dir=".")
    out_path = os.path.join(tmp, "rank")
    ctx = multiprocessing.get_context("spawn")
    # four BLAS threads a rank: the host's cores are shared by the ranks
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS")}
    os.environ.update(OMP_NUM_THREADS="4", OPENBLAS_NUM_THREADS="4")
    try:
        procs = [ctx.Process(target=_sharded_rank, args=(r, world, tmp, backend, job, out_path))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        for p in procs:
            p.join(max(1.0, SHARDED_TIMEOUT - (time.perf_counter() - t0)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        reports = []
        for r in range(world):
            path = f"{out_path}{r}"
            if not os.path.exists(path):
                reports.append(None)
                continue
            with open(path, "rb") as fh:
                reports.append(pickle.load(fh))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    if hung:
        raise AssertionError(f"[{tag}] ranks {hung} did not finish within {SHARDED_TIMEOUT} s")
    for r, rep in enumerate(reports):
        if rep is None or rep[0] != "ok":
            raise AssertionError(f"[{tag}] rank {r} failed:\n{rep[1] if rep else 'no report'}")
    wall = time.perf_counter() - t0
    reports = [rep[1] for rep in reports]
    for rep in reports:
        print(f"[{tag}] rank {rep['rank']}: sharded run {rep['wall']:.2f} s, by part "
              f"{ {k: round(v, 3) for k, v in rep['parts'].items()} } s; in collectives "
              f"{rep['collective_s']:.2f} s ({rep['collective_calls']} calls, "
              f"{rep['collective_gib']:.3f} GiB sent, {rep['host_copy_gib']:.3f} GiB copied "
              f"between card and host); peak memory {rep['peak_gib']:.3f} GiB; deposit kernel "
              f"launches {rep['launches']}")
    print(f"[{tag}] {world} ranks ({backend}) from spawn to exit {wall:.1f} s; single-device "
          f"reference on rank 0 {reports[0].get('single_wall', float('nan')):.2f} s")
    numbers, ok = reports[0]["gates"]
    if not ok:
        raise AssertionError(f"[{tag}] the sharded run disagrees with the single-device run: "
                             f"{numbers}")
    return reports


def sharded_phase(kernels):
    """Phase 17: the multi-GPU layer on the card.  17a: run_sharded_coeval
    of the main path's simple+size-medium box at z=8 over NCCL with one rank
    in this process, against run_coeval of the same seed; 17b: the
    headline's box at z=8 on two ranks sharing the card (gloo, collectives
    through host memory), against the single-device run; 17c: the headline's
    physics as run_sharded_lightcone at 128^3 over 9 nodes, against
    generate_lightcone per node and per cone; 17d: the latest-discrete
    template at 64^3 to z=10 (the slab sampler's statistics, the sharded
    painting against the single-device HaloBox); 17e: 17b over NCCL with one
    card a rank where there are two cards.  The sharded paths deposit with
    index_add_, as the JAX package's sharded perturb scatters with XLA:
    every rank reports its deposit-kernel launches (0)."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.ops import deposit
    from py21cmfast_torch.parallel import multihost
    from py21cmfast_torch.parallel.driver import run_sharded_coeval
    from py21cmfast_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    # 17a: NCCL, one rank, in this process
    inputs = p21.InputParameters.from_template(MAIN_TEMPLATE, random_seed=SEED)
    multihost.initialize(backend="nccl")
    try:
        mesh = make_mesh(1)
        deposit.cic_deposit_swept.launches = 0
        (out,), wall = _sync_time(lambda: run_sharded_coeval(inputs, [8.0], mesh=mesh))
        launches = deposit.cic_deposit_swept.launches
        print(f"[sharded-simple] run_sharded_coeval({MAIN_TEMPLATE}, [8.0]) over {mesh}: "
              f"{wall:.3f} s (first call), {mesh.stats['calls']} collectives, deposit kernel "
              f"launches {launches}")
        got = {k: _host(v) for k, v in _node_fields(out).items()}
        del out
        (cv,) = p21.run_coeval(inputs, [8.0])
        numbers, ok = _coeval_gates("sharded-simple", 8.0, got,
                                    {k: _host(v) for k, v in _node_fields(cv).items()})
        del cv
        if not ok:
            raise AssertionError(f"[sharded-simple] NCCL sharded run disagrees: {numbers}")
    finally:
        multihost.shutdown()
    torch.cuda.empty_cache()
    paths = {"sharded_simple": launches}
    for tag, job in (("sharded-headline", "_sharded_headline_job"),
                     ("sharded-lightcone", "_sharded_lightcone_job"),
                     ("sharded-discrete", "_sharded_discrete_job")):
        reports = _run_sharded(tag, job)
        paths[tag.replace("-", "_")] = sum(r["launches"] for r in reports)
    if torch.cuda.device_count() >= 2:
        reports = _run_sharded("sharded-headline-nccl", "_sharded_headline_job", backend="nccl")
        paths["sharded_headline_nccl"] = sum(r["launches"] for r in reports)
    else:
        print(f"[sharded-headline-nccl] skipped: {torch.cuda.device_count()} CUDA device on this "
              "host, and NCCL takes one card a rank (17a ran NCCL with one rank)")
    for k in kernels:
        k["launches_by_path"].update(paths)
        k["launches"] = sum(k["launches_by_path"].values())
    if any(paths.values()):
        raise AssertionError(f"a sharded path launched the deposit kernel: {paths}")
    print(f"[sharded] phase 17 in {time.perf_counter() - t_phase:.1f} s; deposit kernel launches "
          f"by sharded path {paths}")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this check runs only on an NVIDIA GPU")
    import py21cmfast_torch  # noqa: F401  (fails outside a checkout of the repository)

    t0 = time.perf_counter()
    card_info()
    check_host_memory()
    cpu_global = start_global_on_cpu()
    try:
        build_kernels()
        entry, headline = kernel_phase()
        kernels = [entry]
        dens_swept = small_coeval_phase()
        perturb_paths_phase(dens_swept)
        evolving_small_phase()
        lightcone_small_phase()
        minihalo_small_phase()
        fixed_halos_small_phase()
        discrete_small_phase()
        slice_small_phase()
        main_path_phase(kernels)
        stage_phase()
        scroll_stage_phase(*scroll_phase(kernels))
        base = headline_phase(kernels, headline)
        photoncons_headline_phase(kernels, headline, base)
        del headline
        torch.cuda.empty_cache()
        cli_phase(kernels, base)
        del base
        torch.cuda.empty_cache()
        minihalo_headline_phase(kernels)
        torch.cuda.empty_cache()
        fixed_halos_headline_phase(kernels)
        torch.cuda.empty_cache()
        discrete_headline_phase(kernels)
        torch.cuda.empty_cache()
        samplers_headline_phase(kernels)
        global_phase(cpu_global)
        torch.cuda.empty_cache()
        sharded_phase(kernels)
    finally:
        if cpu_global[0].is_alive():
            cpu_global[0].terminate()
        cpu_global[0].join()
    print(f"[total] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
