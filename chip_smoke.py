#!/usr/bin/env python3
"""Check py21cmfast_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

This is a check, not a benchmark: benchmark/run.py times the port end to
end.  The one set of times printed here is the kernels line (below).

Phases, in order; any failure raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     the host has the free memory phases 12 and 14 need;
  2. every CUDA kernel in py21cmfast_torch/csrc builds (one nvcc per
     source, in parallel; ptxas's register report printed), and the R = 3
     deposit's shared-memory adds are native integer ATOMS.ADD in its SASS;
  3. the deposit kernel against its plain PyTorch version on the card: edge
     cases, then the perturb's own z=8 inputs at the simple coeval's shape
     (384^3 -> 128^3) and at the headline lightcone's (768^3 -> 256^3),
     each cell within 1e-5 of its mass and the total mass within 1e-6; at
     the two main-path shapes, CUDA-event times of the kernel and its plain
     version against the byte bound (the kernels line);
  4. a golden-size coeval (HII_DIM=24) on the card against the same coeval on
     the CPU, from the same hires density;
  4b. the same for PERTURB_DEPOSIT="SCATTER" and PERTURB_ON_HIGH_RES, which
     reach the same kernel, and PERTURB_ON_HIGH_RES at the main path's size
     (a finite density, the kernel against its plain version);
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
     (HII_DIM=128, DIM=384, 256 Mpc) at z=10 and z=8: one deposit launch a
     redshift, no Ts shell kernel, finite fields, xH in [0, 1] and falling;
  7. the second main path: the same template with USE_TS_FLUCT and
     inhomogeneous recombinations, evolved down its node ladder to z=8 (37
     nodes of ZPRIME_STEP_FACTOR=1.04) through generate_coeval: every node
     yielded with finite fields, one deposit launch a node, two Ts shell
     kernel launches a shell, Tk past its minimum, recombinations
     accumulated;
  9. the third main path, the repo's headline lightcone: bench.py's physics
     (bench.py:73-91) with MINIMIZE_MEMORY on, which bench.py turns on only
     at DIM >= 4 HII_DIM, at HII_DIM=256, DIM=768, BOX_LEN=384,
     USE_TS_FLUCT, inhomogeneous recombinations, 92 nodes from z=35.37 to
     z=5, 2566 slices, through generate_lightcone with the
     velocity-gradient correction and RSDs: every node with finite fields,
     one deposit launch a node, the Ts shell kernels taken, a fully written
     finite cone, a falling global xH;
  10. the fourth main path: the Munoz21 (EOS21) lightcone at the headline's
     box and ladder cut to z=15 (256^3/768^3, 42 nodes), as phase 9 but on
     the Ts torch path, with a well-formed v_cb box, a Lyman-Werner
     background and turnover masses in range;
  11. the fifth main path: the fixed-halos template (L-INTEGRAL sources
     through the HaloBox and the XraySourceBox, USE_EXP_FILTER, CELL_RECOMB)
     at the headline's box and ladder cut to z=15, as phase 10, with a
     HaloBox at every node;
  12. the sixth main path: the latest-discrete template (CHMF-SAMPLER with
     MASS-LIMITED progenitors, USE_TS_FLUCT, INHOMOGENEOUS) at 128^3 / 384^3
     in a 192 Mpc box (its 1.5 Mpc cell) down the headline's ladder cut to
     z=8 (72 nodes), as phase 10, from the default CUDA generators, with a
     statistical gate on the z=8 grid sample (its count within 1% of the
     expected, each of 4 mass octaves within 5 sigma of the conditional MF);
  13. the headline lightcone of phase 9 under Z-PHOTONCONS (run right after
     phase 9, from its ICs), its ladder cut to z=15, as phase 9: one deposit
     launch a node and a calibration step, and the nodes shifted;
  14. generate_coeval of the latest-discrete template at phase 12's box
     down to z=10, once with PARTITION and once with BINARY-SPLIT
     progenitors: every node, one deposit launch a node, finite fields, and
     the first progenitor step's 4 mass octaves against the conditional MF;
  15. run_global_evolution (the 0-D history) on the headline's inputs on
     the card against the same run on the CPU, which runs in a process of
     its own beside the card's phases from the start;
  16. (right after phase 13) the command line: `python -m py21cmfast_torch
     template avail` and `run params` in subprocesses, then `cli.main` of
     `run lightcone` on the headline's settings cut to z=15 (42 nodes, one
     deposit launch each, a finite 256^2 cone); the power spectrum of a z~8
     chunk of phase 9's Tb cone on the card against the CPU, the Thomson
     optical depth of phase 9's global xH, and convert_halo_properties of
     1e7 masses on the card against the CPU.
  17. the multi-GPU layer, py21cmfast_torch.parallel, each run against the
     single-device run of the same seed, with no deposit or Ts shell kernel
     launch: 17a run_sharded_coeval of the simple box at z=8 over NCCL with
     one rank in this process; 17b two ranks sharing the one card (gloo,
     collectives through host memory) on the headline's box at z=8; 17c the
     headline's physics as run_sharded_lightcone at 128^3 over 9 nodes per
     node and cone, its last node's (z=8) Ts step compared stage by stage;
     17d the latest-discrete template at 64^3 to z=10 (the slab sampler's
     statistics, the sharded painting); 17e 17b over NCCL with one card a
     rank, only where there are two cards.
  18. the faithful lightcone, bench.py's full1024: the reference's own DIM =
     4 HII_DIM ratio, HII_DIM=256, DIM=1024, MINIMIZE_MEMORY on: the ratio-4
     kernel against its plain version (run in hires x-slabs: whole, it does
     not fit the card) on the perturb's own z=8 inputs at 1024^3 -> 256^3,
     with phase 3's times and bound; then the lightcone to z=8 (72 of its 92
     nodes) as phase 9.
  19. the spin temperature's fused shell kernels (csrc/ts_shell.cu) at
     256^3 over the real 40-shell ladder of the latest template's z=25 Ts
     step (its host tables; a lognormal density and an x_e across the
     knots): the kernel path against the plain torch path on the card in
     four cases (the Chebyshev fit, the table gather, CONST-ION-EFF, Lya
     heating off; relative L2 of each accumulator <= 1e-5, two runs
     bit-identical), then CUDA-event times of the whole scan on both paths
     and of the two kernels alone over the 40 shells against their byte
     bound.  Its row of the kernels line gives the kernels' launches on
     each main path of the phases before, each path's counts zeroed just
     before it ran and read just after: two a shell the kernels took, on the
     scroll, the headline, Z-PHOTONCONS, the command line and the faithful
     lightcone, none on the simple, minihalo, fixed-halos, discrete and
     sharded paths.
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


def _counted(name):
    """The process's total of a recorder counter over its stages
    (py21cmfast_torch.tracing)."""
    from py21cmfast_torch import tracing

    return sum(tracing.totals()["counters"].get(name, {}).values())


# the fused Ts shell kernels' launches on each main path, by path (phase
# 19's row of the kernels line)
TS_SHELL_BY_PATH = {}


def _ts_shell_zero():
    """Zero the Ts shell kernels' launch counts just before a main path runs;
    returns the recorder's `ts.kernel_shells` so far."""
    from py21cmfast_torch.ops import ts_shell

    ts_shell.ts_shell_reduce.launches = ts_shell.ts_shell_accumulate.launches = 0
    return _counted("ts.kernel_shells")


def _ts_shell_read(path, shells0, taken=None):
    """Read the Ts shell kernels' launches just after a main path ran (zeroed
    by `_ts_shell_zero`, which returned `shells0`) into TS_SHELL_BY_PATH:
    two a shell the kernels took, one of each kernel; with `taken` the
    path took the kernels (True: single-device Eulerian Ts without
    minihalos) or the torch code (False).  Returns the launches."""
    from py21cmfast_torch.ops import ts_shell

    shells = _counted("ts.kernel_shells") - shells0
    reduce_n = ts_shell.ts_shell_reduce.launches
    accumulate_n = ts_shell.ts_shell_accumulate.launches
    if not reduce_n == accumulate_n == shells:
        raise AssertionError(f"{path}: {reduce_n} ts_shell_reduce and {accumulate_n} "
                             f"ts_shell_accumulate launches for {shells} kernel shells")
    if taken is not None and (shells > 0) != taken:
        raise AssertionError(f"{path}: {shells} shells took the Ts shell kernels, expected "
                             f"{'some' if taken else 'none'}")
    TS_SHELL_BY_PATH[path] = reduce_n + accumulate_n
    return reduce_n + accumulate_n


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

    logs = _kernels.build()
    print(f"[build] {len(logs)} of {len(_kernels.sources())} sources compiled")
    for name, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            # ptxas names the function, then its stack and spills, then registers
            # the R = 3 kernel of the headline and the R = 4 one of phase 18
            if "Compiling entry function" in line and (
                    "kernelILi3E" in line or "kernelILi4E" in line or "ts_shell" in line):
                print(f"[build] {name}: {line.split(chr(39))[1]}: "
                      + "; ".join(x.strip() for x in lines[i + 1:i + 4] if "bytes" in x or "registers" in x))
    _check_shared_atomic_opcodes()


def _check_shared_atomic_opcodes():
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


def check_deposit(hires, d, d_init, ratio, label, plain_rows=None):
    """Kernel vs plain on the card (masses must be positive), cell by cell:
    |kernel - plain| <= 1e-5 max(plain_cell, mean(plain)), and the kernel's
    total mass equal to the plain total and to the exact particle mass within
    1e-6 relative (float64 sums).  Both sides add float32 atomics in a
    run-dependent order; the rounding of such a sum grows with the cell's own
    mass (the plain version adds ~1700 single terms into a cell of 8x the mean
    mass at the main-path shape, at an ulp of 1.5e-5), so the bound follows
    the cell where it holds more than the mean.  `plain_rows` runs the plain
    version in hires x-slabs of that many rows (one accumulator)."""
    import torch

    from py21cmfast_torch.ops import deposit

    plain = deposit.cic_deposit_swept_plain(hires, *d, d_init, ratio, x_rows=plain_rows)
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
    print(f"[deposit] {label}: "
          f"max|kernel-plain| {err:.3e} (mean mass {mean:.3f}), "
          f"max |kernel-plain|/max(plain, mean) {worst:.3e} (limit 1e-5), "
          f"mass kernel {tot_k:.9e} plain {tot_p:.9e} exact {tot_exact:.9e} -> "
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


def _time_deposit(hires, d, d_init, ratio, label, reps=20, plain_rows=None):
    """Kernel against plain at one shape, then the kernels line's CUDA-event
    timings: the kernel's median of single calls (each between its own pair
    of events, so it holds the host's time to enqueue one call), a call in a
    run of 50, the plain version's median, and the bound."""
    import torch

    from py21cmfast_torch.ops import deposit

    err, worst = check_deposit(hires, d, d_init, ratio, label, plain_rows)

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

    kernel_ms, batch_ms = _event_median_ms(kernel, reps), batched_ms()
    plain_ms = _event_median_ms(lambda: deposit.cic_deposit_swept_plain(hires, *d, d_init, ratio,
                                                                          x_rows=plain_rows),
                                max(3, reps // 2))
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
    inputs and ICs."""
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
    ics = p21.compute_initial_conditions(inputs)
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
    return entry, (inputs, ics)


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
    384^3 onto 384^3, and the kernel against its plain version there."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import perturb

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
    pf = p21.perturb_field(8.0, inputs, ics)
    if tuple(pf.density.shape) != so.lowres_shape or not bool(torch.isfinite(pf.density).all()):
        raise AssertionError("PERTURB_ON_HIGH_RES at the main path's size: bad density")
    _, D_init, fac_za, fac_2lpt = perturb._displacement_factors(inputs, 8.0)
    d = perturb._displacement_cells(
        (ics.vx, ics.vy, ics.vz), (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT),
        fac_za, fac_2lpt, tuple(n / L for n, L in zip(so.hires_shape, so.box_lens)),
    )
    d_init = float(np.float32(D_init))
    check_deposit(ics.hires_density, d, d_init, 1, f"PERTURB_ON_HIGH_RES z=8 hires {so.hires_shape}")
    print(f"[hires] PERTURB_ON_HIGH_RES z=8 at {so.hires_shape} -> {so.hires_shape}: displacement "
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
    import py21cmfast_torch as p21
    from py21cmfast_torch.ops import deposit

    wrappers = {"cic_deposit_swept": deposit.cic_deposit_swept}
    inputs = p21.InputParameters.from_template(MAIN_TEMPLATE, random_seed=SEED)
    for w in wrappers.values():
        w.launches = 0
    shells0 = _ts_shell_zero()
    coevals = p21.run_coeval(inputs, MAIN_REDSHIFTS)
    launches = {name: w.launches for name, w in wrappers.items()}
    _ts_shell_read("simple", shells0, taken=False)
    print(f"[main] run_coeval({MAIN_TEMPLATE}, {MAIN_REDSHIFTS}) on the card: launches {launches}")
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
    the ladder down to z=8; launch counts zeroed just before."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.ops import deposit

    wrappers = {"cic_deposit_swept": deposit.cic_deposit_swept}
    inputs = _scroll_inputs()
    so = inputs.simulation_options
    nodes = list(inputs.node_redshifts)
    print(f"[scroll] {MAIN_TEMPLATE} + {SCROLL_OPTIONS}, ZPRIME_STEP_FACTOR "
          f"{so.ZPRIME_STEP_FACTOR}, Z_HEAT_MAX {so.Z_HEAT_MAX}: {len(nodes)} nodes "
          f"{nodes[0]:.3f} -> {nodes[-1]:.3f}")

    for w in wrappers.values():
        w.launches = 0
    shells0 = _ts_shell_zero()
    means = []
    for i, cv in enumerate(p21.generate_coeval(inputs)):
        if cv.redshift != nodes[i]:
            raise AssertionError(f"node {i}: yielded z={cv.redshift}, expected {nodes[i]}")
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
    launches = {name: w.launches for name, w in wrappers.items()}
    _ts_shell_read("scroll", shells0, taken=True)

    if len(means) != len(nodes):
        raise AssertionError(f"{len(means)} coevals from {len(nodes)} nodes")
    for k in kernels:
        k["launches_by_path"]["scroll"] = launches[k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
        if launches[k["name"]] < 1:
            raise AssertionError(f"the scroll never launched {k['name']}")
    if launches["cic_deposit_swept"] != len(nodes):
        raise AssertionError(f"expected {len(nodes)} deposit launches in the scroll, got {launches}")

    print(f"[scroll] {len(nodes)} nodes on the card; launches {launches}")
    for i in sorted({0, len(nodes) // 4, len(nodes) // 2, 3 * len(nodes) // 4}):
        xh, tb, tk, tsp, xe, nrec = means[i]
        print(f"[scroll] node {i:2d} z={nodes[i]:7.3f}: <xH> {xh:.6f}, <Tb> {tb:.4f} mK, <Tk> "
              f"{tk:.4f} K, <Ts> {tsp:.4f} K, <x_e> {xe:.3e}, <N_rec> {nrec:.3e}")
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
                rows, m = chunk(inp, h, md, cond_t, m_tgt, n_exp, None, dev)
                out[dev] = (rows.cpu(), m.cpu().double())
            (rc, mc), (rg, mg) = out["cpu"], out["cuda"]
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
                  f"{rc.numel()} progenitors; {txt}")
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
            cals[key] = calibrate(inputs, z_ana, q_ana, device=device)
        return cals[key]

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
# the depth cuts that keep the whole script within its time: phases 12 and 18
# run the headline's ladder down to z=8 (72 of its 92 nodes), phases 10, 11,
# 13 and 16 down to z=15 (42 nodes)
CUT_Z_END = 8.0
SHORT_Z_END = 15.0
# MINIMIZE_MEMORY is on in every headline phase; bench.py turns it on only at
# DIM >= 4 HII_DIM, and the benchmark's 768^3 cells run with it off, so phase
# 9 is where the MINIMIZE_MEMORY path runs at ratio 3 (phase 18: ratio 4)
HEADLINE_BOX = dict(HII_DIM=256, DIM=768, BOX_LEN=384.0, Z_HEAT_MAX=35.0, ZPRIME_STEP_FACTOR=1.02,
                    MINIMIZE_MEMORY=True)
# phase 18: the reference's own DIM = 4 HII_DIM ratio (bench.py's full1024)
FAITHFUL_DIM = 1024


def _headline_inputs(dim=HEADLINE_BOX["DIM"], z_end=HEADLINE_Z_END):
    """The repo's headline lightcone, bench.py's physics (bench.py:73-91)
    with MINIMIZE_MEMORY on: 256^3 at 1.5 Mpc cells with a `dim`^3 hires
    grid, E-INTEGRAL sources, USE_TS_FLUCT, inhomogeneous recombinations,
    nodes from z=35.37 down to `z_end` (92 to z=5)."""
    import py21cmfast_torch as p21

    return p21.InputParameters(random_seed=HEADLINE_SEED).evolve_input_structs(
        SOURCE_MODEL="E-INTEGRAL", USE_TS_FLUCT=True, RECOMB_MODEL="inhomogeneous",
        R_BUBBLE_MAX=50.0, USE_EXP_FILTER=False, CELL_RECOMB=False, **{**HEADLINE_BOX, "DIM": dim},
    ).with_logspaced_redshifts(z_end)


def _minihalo_headline_inputs():
    """The Munoz21 template (minihalos, LW feedback, v_cb FLUCTS, USE_TS_FLUCT,
    inhomogeneous recombinations, SHARP-K, R_BUBBLE_MAX=50) at the headline's
    box and node ladder, down to SHORT_Z_END."""
    import py21cmfast_torch as p21

    return p21.InputParameters.from_template(
        MINIHALO_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**HEADLINE_BOX).with_logspaced_redshifts(SHORT_Z_END)


def _fixed_halos_headline_inputs():
    """The fixed-halos template (L-INTEGRAL, USE_EXP_FILTER, CELL_RECOMB,
    USE_TS_FLUCT, inhomogeneous recombinations, R_BUBBLE_MAX=50) at the
    headline's box and node ladder, down to SHORT_Z_END."""
    import py21cmfast_torch as p21

    return p21.InputParameters.from_template(
        FIXED_HALOS_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**HEADLINE_BOX).with_logspaced_redshifts(SHORT_Z_END)


def lightcone_phase(kernels, inputs, ics, tag, path, setup_launches=None, keep_tb_at=None,
                    ts_kernels=None):
    """A full-size lightcone through generate_lightcone with dvdr and RSDs,
    from ICs computed before (as bench.py hands them in); launch counts zeroed
    just before and read just after (one deposit launch per node, and
    `setup_launches()` more where the run's setup deposits too; two Ts shell
    kernel launches a shell the kernels took, which `ts_kernels` says they
    do or do not).  Every node is yielded in order with finite fields on the
    card, the cone is fully written and finite, and the global xH falls.
    Returns the nodes, their <xH> and <Tb> and the global xH the cone
    recorded; with `keep_tb_at` also a copy of the HII_DIM slices of the
    finished Tb cone centred nearest that redshift, on the card, with its
    redshift and box lengths."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.ops import deposit

    so = inputs.simulation_options
    mini = inputs.astro_options.USE_MINI_HALOS
    lagrangian = inputs.matter_options.source_model_uses_lagrangian_grids
    nodes = list(inputs.node_redshifts)
    lcr, written = _tracked_lightconer(inputs)
    print(f"[{tag}] HII_DIM={so.HII_DIM} DIM={so.DIM} BOX_LEN={so.BOX_LEN}, seed "
          f"{inputs.random_seed}: {len(nodes)} nodes {nodes[0]:.3f} -> {nodes[-1]:.3f}, "
          f"{lcr.n_slices} slices")

    wrappers = {"cic_deposit_swept": deposit.cic_deposit_swept}
    for w in wrappers.values():
        w.launches = 0
    shells0 = _ts_shell_zero()
    xh, tb, mini_means, lc = [], [], [], None
    for i, (z, cv, lc) in enumerate(p21.generate_lightcone(
            inputs, lightconer=lcr, initial_conditions=ics,
            include_dvdr_in_tau21=True, apply_rsds=True)):
        if z is None:
            break
        if i >= len(nodes) or z != nodes[i]:
            raise AssertionError(f"node {i}: yielded z={z}, expected {nodes[i:i + 1]}")
        _check_fields(z, so.lowres_shape, cv.perturbed_field, cv.halobox, cv.spin_temp,
                      cv.ionized_box, cv.brightness_temperature)
        if lagrangian and cv.halobox is None:
            raise AssertionError(f"node {i}: no HaloBox")
        xh.append(cv.neutral_fraction.double().mean().item())
        tb.append(cv.brightness_temp.double().mean().item())
        if mini:
            ion = cv.ionized_box
            mini_means.append((cv.spin_temp.J_21_LW.double().mean().item(),
                               float(ion.log10_Mturnover_ave), float(ion.log10_Mturnover_MINI_ave)))
    launches = {name: w.launches for name, w in wrappers.items()}
    _ts_shell_read(path, shells0, taken=ts_kernels)

    if len(xh) != len(nodes):
        raise AssertionError(f"{len(xh)} nodes yielded of {len(nodes)}")
    for k in kernels:
        k["launches_by_path"][path] = launches[k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
        if launches[k["name"]] < 1:
            raise AssertionError(f"the {tag} lightcone never launched {k['name']}")
    expected = len(nodes) + (setup_launches() if setup_launches else 0)
    if launches["cic_deposit_swept"] != expected:
        raise AssertionError(f"expected {expected} deposit launches in the {tag} lightcone, got {launches}")
    print(f"[{tag}] {len(nodes)} nodes on the card; launches {launches}")

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
    return dict(nodes=nodes, xh=xh, tb=tb, gxh=np.asarray(gxh), **kept)


def headline_phase(kernels, headline):
    """Phase 9: the headline lightcone from the ICs phase 3 computed."""
    inputs, ics = headline
    return lightcone_phase(kernels, inputs, ics, "headline", "lightcone", keep_tb_at=8.0,
                           ts_kernels=True)


def minihalo_headline_phase(kernels):
    """Phase 10: the Munoz21 lightcone at the headline's box and ladder,
    after a check of its ICs' v_cb box."""
    import torch

    import py21cmfast_torch as p21

    inputs = _minihalo_headline_inputs()
    so = inputs.simulation_options
    ics = p21.compute_initial_conditions(inputs)
    v = ics.lowres_vcb
    print(f"[munoz21] ICs at {so.hires_shape} -> {so.lowres_shape} with the v_cb box: |v_cb| mean "
          f"{v.double().mean().item():.4f} km/s, rms {v.double().square().mean().sqrt().item():.4f}, "
          f"min {v.min().item():.4f}, max {v.max().item():.4f}")
    if tuple(v.shape) != so.lowres_shape or not bool(torch.isfinite(v).all()) or not v.min().item() >= 0:
        raise AssertionError("the Munoz21 v_cb box is malformed")
    lightcone_phase(kernels, inputs, ics, "munoz21", "minihalo_lightcone", ts_kernels=False)


def fixed_halos_headline_phase(kernels):
    """Phase 11: the fixed-halos lightcone at the headline's box and ladder."""
    import py21cmfast_torch as p21

    inputs = _fixed_halos_headline_inputs()
    if inputs.matter_options.SOURCE_MODEL != "L-INTEGRAL":
        raise AssertionError(f"{FIXED_HALOS_TEMPLATE} does not use L-INTEGRAL sources")
    ics = p21.compute_initial_conditions(inputs)
    lightcone_phase(kernels, inputs, ics, "fixed-halos", "fixed_halos_lightcone", ts_kernels=False)


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
def _recorded_chain():
    """Record what the gates read of generate_coeval's catalog chain while
    the block runs: the lowest node's grid sample and its tables (`gate`),
    and the first progenitor step's descendant and progenitor masses
    (`first_step`).  Yields the record."""
    from py21cmfast_torch.models import halos

    rec = dict(gate={}, first_step={})
    gate = rec["gate"]
    originals = {name: getattr(halos, name) for name in (
        "sample_halo_grid", "grid_sampler_tables", "_sample_progenitors")}

    def tables(z, *a, **kw):
        gate["h"] = originals["grid_sampler_tables"](z, *a, **kw)
        gate["z"] = z
        return gate["h"]

    def sampled(*a, **kw):
        masses, pos = originals["sample_halo_grid"](*a, **kw)
        gate["masses"] = masses
        return masses, pos

    def progenitors(z, inputs_, prev_cat, *a, **kw):
        cat = originals["_sample_progenitors"](z, inputs_, prev_cat, *a, **kw)
        if not rec["first_step"]:
            rec["first_step"].update(z_prev=float(prev_cat.redshift), z=z,
                                     desc=prev_cat.halo_masses.cpu(), prog=cat.halo_masses.cpu())
        return cat

    halos.sample_halo_grid = sampled
    halos.grid_sampler_tables = tables
    halos._sample_progenitors = progenitors
    try:
        yield rec
    finally:
        for name, fn in originals.items():
            setattr(halos, name, fn)


def discrete_headline_phase(kernels):
    """Phase 12, the sixth main path: the latest-discrete lightcone
    (CHMF-SAMPLER, MASS-LIMITED progenitors, USE_TS_FLUCT, INHOMOGENEOUS)
    at 128^3 / 384^3 in 192 Mpc down the headline's ladder cut to
    CUT_Z_END (72 nodes), from the default CUDA generators, through
    lightcone_phase.  A statistical gate on the z=8 grid sample: its count
    within 1% of the expected sum(n_exp) (plus one halo per collapsed
    cell), and its count in each of 4 mass octaves from SAMPLER_MIN_MASS
    within 5 sigma of the conditional MF's expectation."""
    import torch

    import py21cmfast_torch as p21

    inputs = p21.InputParameters.from_template(
        DISCRETE_TEMPLATE, random_seed=HEADLINE_SEED
    ).evolve_input_structs(**DISCRETE_BOX).with_logspaced_redshifts(CUT_Z_END)
    so = inputs.simulation_options
    if not inputs.matter_options.source_model_uses_halo_sampler:
        raise AssertionError(f"{DISCRETE_TEMPLATE} does not sample halos")
    ics = p21.compute_initial_conditions(inputs)

    with _recorded_chain() as chain:
        lightcone_phase(kernels, inputs, ics, "latest-discrete", "discrete_lightcone",
                        ts_kernels=False)

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
    box and ladder are cut to SHORT_Z_END (42 of its 92 nodes, the slowest
    50 dropped), which keeps the script within its time.  The calibration's
    coevals and their z range, then <xH> and <Tb> at SHORT_Z_END beside
    phase 9's (`base`) at its node nearest SHORT_Z_END, from the same seed
    and ICs."""
    import torch

    from py21cmfast_torch.drivers import coeval
    from py21cmfast_torch.models import photoncons
    from py21cmfast_torch.ops import deposit

    inputs, ics = headline
    inputs = inputs.evolve_input_structs(PHOTON_CONS_TYPE="Z-PHOTONCONS").with_logspaced_redshifts(
        SHORT_Z_END)
    calibrate = photoncons.calibrate_photon_cons
    rec = {}

    def counted_calibration(*a, **kw):
        n0 = deposit.cic_deposit_swept.launches
        out = calibrate(*a, **kw)
        rec["z_cal"], rec["launches"] = out[0], deposit.cic_deposit_swept.launches - n0
        return out

    photoncons.calibrate_photon_cons = counted_calibration
    try:
        run = lightcone_phase(kernels, inputs, ics, "z-photoncons", "photoncons_lightcone",
                              setup_launches=lambda: len(rec["z_cal"]), ts_kernels=True)
    finally:
        photoncons.calibrate_photon_cons = calibrate
    z_cal = rec["z_cal"]
    if rec["launches"] != len(z_cal):
        raise AssertionError(f"the calibration launched the deposit {rec['launches']} times in "
                             f"{len(z_cal)} steps")
    state = coeval.setup_photon_cons(inputs)
    print(f"[z-photoncons] the calibration's {len(z_cal)} coevals (256^3 from 768^3 ICs of their "
          f"own) z {z_cal[0]:.3f} -> {z_cal[-1]:.3f}")
    zi, j = run["nodes"][-1], int(np.argmin(np.abs(np.asarray(base["nodes"]) - SHORT_Z_END)))
    print(f"[z-photoncons] {len(run['nodes'])} nodes to z={zi:.4f} (computed at "
          f"z={state.adjusted_redshift(zi):.4f}): <xH> {run['xh'][-1]:.6f}, <Tb> {run['tb'][-1]:.5f} "
          f"mK; without the correction (phase 9, z={base['nodes'][j]:.4f}) <xH> "
          f"{base['xh'][j]:.6f}, <Tb> {base['tb'][j]:.5f} mK")
    if not (state.adjusted_redshift(8.0) < 8.0 and zi == SHORT_Z_END):
        raise AssertionError("Z-PHOTONCONS shifted no node of the headline lightcone")
    torch.cuda.empty_cache()


# phase 16: the command line on the headline's settings (bench.py's physics,
# bench.py:73-91, with MINIMIZE_MEMORY on), its ladder cut to SHORT_Z_END
CLI_Z_END = SHORT_Z_END
CLI_NODES = 42
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
    each its exit code, its output and its errors."""
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
    return outs


def cli_phase(kernels, base):
    """Phase 16: the command line and the surroundings of the port.
    `python -m py21cmfast_torch template avail` and `run params` in
    subprocesses of their own, run together (this machine has no h5py and no matplotlib,
    which the package imports only where a command needs them); then
    `cli.main` runs the headline lightcone to CLI_Z_END in this process, launch
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
    outs = _cli_subprocesses(commands)
    for args, (code, out, err) in zip(commands, outs):
        lines = out.splitlines()
        print(f"[cli] python -m py21cmfast_torch {' '.join(args)}: exit {code}, {len(lines)} "
              f"lines, first {lines[0] if lines else ''!r}")
        if code != 0 or not lines:
            raise AssertionError(f"python -m py21cmfast_torch {' '.join(args)} failed:\n{out}{err}")

    wrappers = {"cic_deposit_swept": deposit.cic_deposit_swept}
    torch.cuda.empty_cache()
    out = io.StringIO()
    for w in wrappers.values():
        w.launches = 0
    shells0 = _ts_shell_zero()
    with contextlib.redirect_stdout(out):
        lc = cli.main(CLI_ARGS)
    launches = {name: w.launches for name, w in wrappers.items()}
    _ts_shell_read("cli_lightcone", shells0, taken=True)
    line = [ln for ln in out.getvalue().splitlines() if ln.startswith("lightcone:")][-1]
    nodes = lc.node_redshifts
    print(f"[cli] 21cmfast-torch {' '.join(CLI_ARGS)}")
    print(f"[cli] its output: {line}")
    print(f"[cli] {len(nodes)} nodes {nodes[0]:.3f} -> {nodes[-1]:.3f} on the card; launches "
          f"{launches}")
    for k in kernels:
        k["launches_by_path"]["cli_lightcone"] = launches[k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
        if launches[k["name"]] < 1:
            raise AssertionError(f"the command line's lightcone never launched {k['name']}")
    lo, hi = (float(v) for v in line.split("Tb range [")[1].split("]")[0].split(","))
    bt = lc.brightness_temp
    if not (len(nodes) == CLI_NODES and launches["cic_deposit_swept"] == len(nodes)):
        raise AssertionError(f"expected {CLI_NODES} nodes and as many deposit launches: "
                             f"{len(nodes)}, {launches}")
    if not (line.startswith("lightcone: shape=(256, 256, ") and np.isfinite([lo, hi]).all() and lo < hi
            and bt.is_cuda and bool(torch.isfinite(bt).all())):
        raise AssertionError(f"the command line's lightcone is not a finite 256^2 cone: {line}")
    del lc, bt
    torch.cuda.empty_cache()

    chunk, lens = base["tb_chunk"], base["chunk_lens"]
    k_g, p_g, n_g = ps.power_spectrum_1d(chunk, lens)
    k_c, p_c, n_c = ps.power_spectrum_1d(chunk.cpu(), lens)
    good = np.isfinite(p_c) & (n_c > 0)
    rel = np.abs(p_g[good] - p_c[good]) / np.abs(p_c[good])
    print(f"[cli] P(k) of phase 9's Tb cone, {tuple(chunk.shape)} slices centred at "
          f"z={base['chunk_z']:.3f} ({lens[2]:.1f} Mpc along the line of sight), 16 log bins: "
          f"max rel diff "
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
    props_g = cfuncs.convert_halo_properties(disc, 8.0, masses, *rngs)
    props_c = cfuncs.convert_halo_properties(disc, 8.0, masses, *rngs, device="cpu")
    errs = {}
    for name, c in props_c.items():
        g = props_g[name]
        scale = np.maximum(np.abs(c), np.finfo(np.float32).tiny)
        errs[name] = float(np.max(np.abs(g.astype(np.float64) - c) / scale))
    print(f"[cli] convert_halo_properties of {HALO_PROPS_N:.0e} masses 1e8-1e12 Msun at z=8 "
          f"({DISCRETE_TEMPLATE}): max rel diff per property "
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
    node).  Each: every node yielded, finite fields at SAMPLERS_Z_END, and a
    gate on the first progenitor step (`_recorded_chain`): its count in each
    of 4 mass octaves from SAMPLER_MIN_MASS within SAMPLER_OCTAVE_TOL of the
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
    ics = p21.compute_initial_conditions(base)
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
        shells0 = _ts_shell_zero()
        n_yielded = 0
        try:
            with _recorded_chain() as chain:
                for last in p21.generate_coeval(inputs, initial_conditions=ics):
                    n_yielded += 1
        finally:
            halos._binary_split_kernel = kernel
        launches = deposit.cic_deposit_swept.launches
        _ts_shell_read(f"{tag}_coeval", shells0, taken=False)
        if n_yielded != len(nodes) or abs(last.redshift - SAMPLERS_Z_END) > 1e-6:
            raise AssertionError(f"{method}: {n_yielded} nodes yielded of {len(nodes)}")
        _check_fields(last.redshift, so.lowres_shape, last.perturbed_field, last.halobox,
                      last.spin_temp, last.ionized_box, last.brightness_temperature)
        for k in kernels:
            k["launches_by_path"][f"{tag}_coeval"] = launches
            k["launches"] = sum(k["launches_by_path"].values())
        if launches != len(nodes):
            raise AssertionError(f"{method}: {launches} deposit launches in {len(nodes)} nodes")
        print(f"[{tag}] {len(nodes)} nodes {nodes[0]:.3f} -> {nodes[-1]:.3f}; <xH> at "
              f"z={last.redshift:.3f} {last.neutral_fraction.double().mean().item():.6f}; launches "
              f"{launches}")
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
    ge = p21.run_global_evolution(inputs, device="cpu")
    with open(path, "wb") as fh:
        pickle.dump(ge.quantities, fh)


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


# the float32 rounding of exp(-tau) in 1 - exp(-tau), which the Ts step's CMB
# coupling and Tb both take: each package's exp is within 2**-24 below 1, so
# two runs may differ by EXP_ULPS * 2**-24 / tau of the result
# (tests/test_torch_parity_scale.py)
EXP_ULPS = 2.0


def _tau21(inputs, z, prev_ts, prev_xe):
    """tau_21 of the Ts step at `z`, from the previous node's Ts and x_e, as
    the step's CMB coupling takes it."""
    from py21cmfast_torch.cosmology.constants import physconst as pc

    cosmo = inputs.cosmology
    z = np.asarray(z, np.float64)
    n_z = cosmo.rho_crit_cgs * cosmo.OMb * (1 - cosmo.Y_He) / pc.m_p * (1 + z) ** 3
    hubble = np.vectorize(lambda v: float(cosmo.hubble(v)))(z)
    return (3 * pc.h_p * pc.A10 * pc.c_cms * pc.lambda_21 ** 2 / 32.0 / np.pi / pc.k_B
            * (1 - prev_xe) * n_z / prev_ts / hubble)


def _global_per_node(inputs, z, cpu, card):
    """Print the card-vs-CPU relative difference of the 0-D history's Ts,
    Tk, x_e and xH at every node, the largest change of each from one node
    to the next, and Ts's difference in units of the float32 rounding of
    exp(-tau_21) in its CMB coupling, 2**-24 / tau_21, with tau_21 from the
    CPU run's previous node."""
    rel = {}
    for name in ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction",
                 "neutral_fraction"):
        c, g = np.asarray(cpu[name], np.float64), np.asarray(card[name], np.float64)
        rel[name] = np.abs(g - c) / np.maximum(np.abs(c), 1e-300)
        steps = np.abs(np.diff(rel[name]))
        k = int(np.argmax(steps))
        print(f"[global] {name}: card-vs-CPU relative difference per node "
              f"{[float(f'{v:.2e}') for v in rel[name]]}; largest change between nodes "
              f"{steps[k]:.2e} from z={z[k]:.3f} to z={z[k + 1]:.3f}")
    ts, xe = (np.asarray(cpu[k], np.float64) for k in ("spin_temperature", "xray_ionised_fraction"))
    tau = _tau21(inputs, z[1:], ts[:-1], xe[:-1])
    units = rel["spin_temperature"][1:] / (2.0 ** -24 / tau)
    k = int(np.argmax(units))
    print(f"[global] spin_temperature difference in units of 2**-24 / tau_21 per node (from the "
          f"second): {[float(f'{v:.2f}') for v in units]}; largest {units[k]:.3f} at "
          f"z={z[k + 1]:.3f} (tau_21 {tau[k]:.3e})")


def global_phase(cpu_run):
    """Phase 15: run_global_evolution on the headline's inputs on the card,
    against the same on the CPU (run beside the card's phases): every
    quantity per node within GLOBAL_REL of its value plus GLOBAL_ABS of the
    series' largest magnitude."""
    import pickle
    import shutil

    import py21cmfast_torch as p21

    inputs = _headline_inputs()
    ge = p21.run_global_evolution(inputs)
    proc, path = cpu_run
    proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"the CPU run of the 0-D history failed (exit code {proc.exitcode})")
    with open(path, "rb") as fh:
        quantities = pickle.load(fh)
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
    _global_per_node(inputs, z, quantities, ge.quantities)
    i8 = int(np.argmin(np.abs(z - 8.0)))
    print(f"[global] run_global_evolution on the headline's inputs, {len(z)} nodes {z[0]:.3f} -> "
          f"{z[-1]:.3f}: xH "
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
# through host memory.

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
# 17c's Ts and Tb bound, a share of the field's maximum, as 17a and 17b's;
# where the run solves Ts, each cell may differ by EXP_ULPS * 2**-24 / tau of
# its own value more (the float32 1 - exp(-tau) of the Ts step's CMB coupling
# and of Tb: 17c's z=8 node showed every input of its Ts step within 1.24e-5
# and Ts within 0.47 of that bound)
SHARDED_CHAIN_TOL = 1e-4
# the latest-discrete template at 64^3 / 192^3 in 96 Mpc (its 1.5 Mpc cell)
# to z=10, its ladder cut to ZPRIME_STEP_FACTOR=1.1: 17d
SHARDED_DISCRETE = dict(HII_DIM=64, DIM=192, BOX_LEN=96.0, Z_HEAT_MAX=35.0, ZPRIME_STEP_FACTOR=1.1)
SHARDED_DISCRETE_Z = 10.0


def _coeval_gates(tag, z, got, ref, tol=1e-4, ts_tau=None):
    """The gates of tests/test_parallel.py:97-100 on one node (density RMS,
    <xH>, rounded xH) plus Ts and Tb within `tol` of their maximum (Tb where
    xH agrees); with a spin temperature each cell of Ts and Tb may differ by
    EXP_ULPS * 2**-24 / tau of its own value more, tau the Ts step's tau_21
    (`ts_tau`, None at a node without a Ts step) and the Tb box's.  Returns
    the numbers and whether every gate holds.  `got` and `ref` map field
    names to float64 numpy arrays."""
    d_s, d_1 = got["density"], ref["density"]
    x_s, x_1 = got["xH"], ref["xH"]
    rms = float(np.sqrt(np.mean((d_s - d_1) ** 2)))
    same = np.abs(x_s - x_1) <= 1e-5

    def share(g, r, tau, where=Ellipsis):
        """The largest share of its bound a cell takes."""
        bound = tol * np.abs(r).max()
        if tau is not None:
            bound = bound + EXP_ULPS * 2.0 ** -24 / np.maximum(tau, 1e-30) * np.abs(r)
        return float((np.abs(g - r) / np.maximum(bound, 1e-300))[where].max())

    out = dict(z=z, density_rms_over_sigma=rms / float(d_1.std()),
               xH=(float(x_s.mean()), float(x_1.mean())),
               rounded_xH_flips=float(np.mean(np.round(x_s, 3) != np.round(x_1, 3))),
               Tb_max_err_over_max=float(np.abs(got["Tb"] - ref["Tb"])[same].max()
                                         / np.abs(ref["Tb"]).max()),
               Tb_of_bound=share(got["Tb"], ref["Tb"], ref.get("tau_Tb"), same))
    ok = (rms < 1e-4 * d_1.std() + 1e-6 and abs(out["xH"][0] - out["xH"][1]) < 1e-3
          and out["rounded_xH_flips"] < 5e-3 and out["Tb_of_bound"] <= 1.0)
    if "Ts" in ref:
        out["Ts_max_err_over_max"] = float(np.abs(got["Ts"] - ref["Ts"]).max()
                                           / np.abs(ref["Ts"]).max())
        out["Ts_of_bound"] = share(got["Ts"], ref["Ts"], ts_tau)
        ok = ok and out["Ts_of_bound"] <= 1.0
    rounding = " + the exp(-tau) rounding" if "Ts" in ref else ""
    print(f"[{tag}] z={z:.3f}: density RMS {out['density_rms_over_sigma']:.3e} sigma (limit "
          f"1e-4), <xH> {out['xH'][0]:.6f} against {out['xH'][1]:.6f}, rounded xH differs in "
          f"{out['rounded_xH_flips']:.2e} of the cells (limit 5e-3), Tb max-abs "
          f"{out['Tb_max_err_over_max']:.2e} of max|Tb| where xH agrees, "
          f"{out['Tb_of_bound']:.3f} of its bound"
          + (f", Ts max-abs {out['Ts_max_err_over_max']:.2e} of its max, "
             f"{out['Ts_of_bound']:.3f} of its bound" if "Ts" in ref else "")
          + f" (bound {tol:.0e} of the max{rounding}, limit 1)")
    return out, ok


def _host(t):
    return None if t is None else t.detach().double().cpu().numpy()


def _node_fields(cv):
    ts = getattr(cv, "spin_temp", None)
    fields = dict(density=cv.perturbed_field.density, xH=cv.ionized_box.neutral_fraction,
                  Tb=cv.brightness_temperature.brightness_temp)
    if ts is not None:
        fields.update(Ts=ts.spin_temperature, x_e=ts.xray_ionised_fraction,
                      tau_Tb=cv.brightness_temperature.tau_21)
    return fields


def _rank_launches(mesh):
    """A rank's report: its deposit and Ts shell kernel launches (a rank's
    process runs one job)."""
    from py21cmfast_torch.ops import deposit, ts_shell

    return dict(rank=mesh.rank, launches=deposit.cic_deposit_swept.launches,
                ts_shell_launches=(ts_shell.ts_shell_reduce.launches
                                   + ts_shell.ts_shell_accumulate.launches))


def _sharded_headline_job(mesh):
    """17b / 17e on one rank: run_sharded_coeval of the headline's box at
    z=8; rank 0 then runs the single-device run_coeval of the same seed (the
    2LPT source of the whole box, as the sharded ICs take it: the
    single-device ICs truncate it above 640^3 cells) and compares."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import ics as ics_module
    from py21cmfast_torch.ops import deposit
    from py21cmfast_torch.parallel.driver import run_sharded_coeval
    from py21cmfast_torch.parallel.mesh import gather_slabs

    inputs = p21.InputParameters(random_seed=HEADLINE_SEED).evolve_input_structs(
        **SHARDED_HEADLINE)
    deposit.cic_deposit_swept.launches = 0
    _ts_shell_zero()
    (out,) = run_sharded_coeval(inputs, [8.0], mesh=mesh)
    report = _rank_launches(mesh)
    got = {k: _host(gather_slabs(mesh, v)) for k, v in _node_fields(out).items()}
    del out
    if mesh.rank == 0:
        torch.cuda.empty_cache()
        ics_module._2LPT_MAX_INHBM_CELLS = float("inf")
        (cv,) = p21.run_coeval(inputs, [8.0], device=mesh.device)
        report["gates"] = _coeval_gates("sharded-headline", 8.0, got,
                                        {k: _host(v) for k, v in _node_fields(cv).items()})
    mesh.barrier()
    return report


@contextlib.contextmanager
def _last_calls(module, *names):
    """Wrap the named functions of `module`: the dict yielded maps each name
    to the bound arguments (defaults applied) and the result of its last
    call."""
    import inspect

    rec, saved = {}, {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        sig = inspect.signature(fn)

        def run(*a, **kw):
            out = fn(*a, **kw)
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            rec[name] = (dict(bound.arguments), out)
            return out
        return run

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield rec
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _ts_stages(rec, to_host):
    """The Ts step of the last recorded node by stage, in the order the step
    computes them: its inputs (the previous node's Ts, Tk, x_e), the box mean
    of x_e and the host tables (SFRD tables, shell constants), the shell
    scan's filtered accumulators, then Ts, Tk, x_e and J_alpha.  `to_host`
    turns a (slab) tensor into a float64 numpy box."""
    from py21cmfast_torch.models import spintemp

    args, out = rec["_ts_cell_update"]
    targs, h = rec["ts_host_tables"]
    stages = {k: to_host(args[k]) for k in ("prev_ts", "prev_tk", "prev_xe")}
    stages["<x_e>"] = np.array([targs["x_e_ave"]], np.float64)
    stages["host constants"] = np.array([v for _, v in sorted(h["consts"].items())], np.float64)
    for k, v in sorted(h.items()):
        if k == "consts" or isinstance(v, (bool, str)) or v is None:
            continue
        try:
            arr = np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in (
                v if isinstance(v, (list, tuple)) else [v])])
        except (TypeError, ValueError):
            continue
        stages[f"host table {k}"] = arr
    names = spintemp._accumulator_names(args["use_xray_heat"], args["use_lya_heat"],
                                        args["use_minihalos"])
    for name, acc in zip(names, args["accs"]):
        stages[f"shell accumulator {name}"] = to_host(acc)
    for name, box in zip(("Ts", "Tk", "x_e", "J_alpha"), out[:4]):
        stages[name] = to_host(box)
    return stages


def _stage_report(tag, inputs, z, got, ref):
    """Print every stage of one node's sharded run against the single-device
    run (max-abs over the reference's max) and the first over 1e-4; Ts also
    as its share of the bound 1e-4 + EXP_ULPS * 2**-24 / tau_21 per cell.
    Returns the stages' errors, the first over 1e-4 and Ts's share."""
    errs = {}
    for k, r in ref.items():
        g = got[k]
        if g.shape != r.shape:
            errs[k] = float("inf")
            continue
        errs[k] = float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-300))
    first = next((k for k, e in errs.items() if e > 1e-4), None)
    tau = _tau21(inputs, z, ref["prev_ts"], ref["prev_xe"])
    rel = np.abs(got["Ts"] - ref["Ts"]) / np.abs(ref["Ts"])
    share = float((rel / (1e-4 + EXP_ULPS * 2.0 ** -24 / tau)).max())
    worst = np.unravel_index(np.argmax(rel), rel.shape)
    print(f"[{tag}] z={z:.3f} by stage, max-abs over max (sharded against single-device): "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    print(f"[{tag}] z={z:.3f}: first stage over 1e-4 of its max: {first}; Ts per cell at most "
          f"{float(rel.max()):.3e} of its value, {share:.3f} of the bound 1e-4 + {EXP_ULPS:g} * "
          f"2**-24 / tau_21 (tau_21 {float(tau[worst]):.3e}, Ts {float(ref['Ts'][worst]):.1f} K, "
          f"Tk {float(ref['Tk'][worst]):.1f} K at the worst cell; tau_21 from "
          f"{float(tau.min()):.2e} to {float(tau.max()):.2e})")
    return dict(errs=errs, first=first, Ts_share=share)


def _sharded_lightcone_job(mesh):
    """17c on one rank: run_sharded_lightcone of SHARDED_LC, every node's
    fields gathered; rank 0 then runs generate_lightcone of the same seed on
    one device and compares per node and per cone.  The last node's (z=8)
    Ts step is recorded on both runs and compared stage by stage."""
    import py21cmfast_torch as p21
    from py21cmfast_torch.models import spintemp
    from py21cmfast_torch.ops import deposit
    from py21cmfast_torch.parallel import driver
    from py21cmfast_torch.parallel.mesh import gather_slabs

    inputs = p21.InputParameters(random_seed=HEADLINE_SEED).evolve_input_structs(
        **SHARDED_LC).with_logspaced_redshifts(SHARDED_LC_Z_END)
    deposit.cic_deposit_swept.launches = 0
    _ts_shell_zero()
    nodes = []
    scroll = driver.run_sharded_coeval

    def kept(*a, **kw):
        out = scroll(*a, **kw)
        for o in out:
            nodes.append({k: _host(gather_slabs(mesh, v)) for k, v in _node_fields(o).items()})
        return out

    driver.run_sharded_coeval = kept
    try:
        with _last_calls(spintemp, "ts_host_tables", "_ts_cell_update") as rec:
            lc = driver.run_sharded_lightcone(inputs, mesh=mesh)
    finally:
        driver.run_sharded_coeval = scroll
    report = _rank_launches(mesh)
    # every rank gathers its slabs of the last Ts step, in one order
    stages = _ts_stages(rec, lambda t: _host(gather_slabs(mesh, t)))
    del rec
    if mesh.rank == 0:
        ref_nodes = []
        ref = None
        with _last_calls(spintemp, "ts_host_tables", "_ts_cell_update") as rec:
            for z, cv, lc_1 in p21.generate_lightcone(inputs, device=mesh.device):
                if cv is not None:
                    ref_nodes.append({k: _host(v) for k, v in _node_fields(cv).items()})
                ref = lc_1
        ref_stages = _ts_stages(rec, _host)
        del rec
        z_last = float(inputs.node_redshifts[-1])
        stages = {"density": nodes[-1]["density"], **stages, "xH": nodes[-1]["xH"],
                  "Tb": nodes[-1]["Tb"]}
        ref_stages = {"density": ref_nodes[-1]["density"], **ref_stages, "xH": ref_nodes[-1]["xH"],
                      "Tb": ref_nodes[-1]["Tb"]}
        report["stages"] = _stage_report("sharded-lightcone", inputs, z_last, stages, ref_stages)
        del stages, ref_stages
        gates, ok = [], len(nodes) == len(ref_nodes) == len(inputs.node_redshifts)
        for i, (z, g, r) in enumerate(zip(inputs.node_redshifts, nodes, ref_nodes)):
            ts_tau = (_tau21(inputs, z, ref_nodes[i - 1]["Ts"], ref_nodes[i - 1]["x_e"])
                      if i else None)
            numbers, node_ok = _coeval_gates("sharded-lightcone", float(z), g, r,
                                             tol=SHARDED_CHAIN_TOL, ts_tau=ts_tau)
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
    deposit.cic_deposit_swept.launches = 0
    _ts_shell_zero()
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
    try:
        (out,) = run_sharded_coeval(inputs, [SHARDED_DISCRETE_Z], mesh=mesh)
    finally:
        halos.grid_sampler_tables, halos.sample_halo_grid = tables, sampler
        halopaint.sharded_halo_grids = paint
    report = _rank_launches(mesh)
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
        single = halobox.compute_halo_grid(painted["z"], inputs, painted["pt"], device=mesh.device)
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
    reports = [rep[1] for rep in reports]
    print(f"[{tag}] {world} ranks ({backend}); deposit and Ts shell kernel launches by rank "
          f"{[(rep['launches'], rep['ts_shell_launches']) for rep in reports]}")
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

    # 17a: NCCL, one rank, in this process
    inputs = p21.InputParameters.from_template(MAIN_TEMPLATE, random_seed=SEED)
    multihost.initialize(backend="nccl")
    try:
        mesh = make_mesh(1)
        deposit.cic_deposit_swept.launches = 0
        shells0 = _ts_shell_zero()
        (out,) = run_sharded_coeval(inputs, [8.0], mesh=mesh)
        launches = deposit.cic_deposit_swept.launches
        _ts_shell_read("sharded_simple", shells0, taken=False)
        print(f"[sharded-simple] run_sharded_coeval({MAIN_TEMPLATE}, [8.0]) over {mesh}: deposit "
              f"kernel launches {launches}")
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
        TS_SHELL_BY_PATH[tag.replace("-", "_")] = sum(r["ts_shell_launches"] for r in reports)
    if torch.cuda.device_count() >= 2:
        reports = _run_sharded("sharded-headline-nccl", "_sharded_headline_job", backend="nccl")
        paths["sharded_headline_nccl"] = sum(r["launches"] for r in reports)
        TS_SHELL_BY_PATH["sharded_headline_nccl"] = sum(r["ts_shell_launches"] for r in reports)
    else:
        print(f"[sharded-headline-nccl] skipped: {torch.cuda.device_count()} CUDA device on this "
              "host, and NCCL takes one card a rank (17a ran NCCL with one rank)")
    for k in kernels:
        k["launches_by_path"].update(paths)
        k["launches"] = sum(k["launches_by_path"].values())
    if any(paths.values()):
        raise AssertionError(f"a sharded path launched the deposit kernel: {paths}")
    sharded_ts = {k: v for k, v in TS_SHELL_BY_PATH.items() if k in paths}
    if any(sharded_ts.values()):
        raise AssertionError(f"a sharded path launched the Ts shell kernels: {sharded_ts}")
    print(f"[sharded] deposit kernel launches by sharded path {paths}")


# hires x-rows a slab of the plain deposit at 1024^3 (~13 GB of positions,
# corner indices and fractions; the whole grid's would be ~100 GiB)
FAITHFUL_PLAIN_ROWS = 128


def faithful_phase(kernels):
    """Phase 18: the ratio-4 kernel against its plain version (in x-slabs)
    on the perturb's own z=8 inputs at 1024^3 -> 256^3 with phase 3's
    timings and bound, then the faithful lightcone from those ICs down to
    CUT_Z_END, as phase 9 (`lightcone_phase`).  Returns the kernels line's
    1024^3 -> 256^3 row."""
    import torch

    import py21cmfast_torch as p21

    inputs = _headline_inputs(FAITHFUL_DIM, CUT_Z_END)
    so = inputs.simulation_options
    if not inputs.matter_options.MINIMIZE_MEMORY:
        raise AssertionError("the faithful lightcone runs with MINIMIZE_MEMORY on (bench.py's rule)")
    torch.cuda.empty_cache()
    ics = p21.compute_initial_conditions(inputs)
    d, d_init, ratio = _main_path_deposit_inputs(inputs, ics, 8.0)
    row = _time_deposit(ics.hires_density, d, d_init, ratio,
                        f"faithful lightcone z=8 hires {so.hires_shape}", reps=10,
                        plain_rows=FAITHFUL_PLAIN_ROWS)
    del d
    torch.cuda.empty_cache()
    lightcone_phase(kernels, inputs, ics, "faithful", "faithful_lightcone", ts_kernels=True)
    return {
        "name": "cic_deposit_swept",
        "shape": "1024^3->256^3",
        "route": "cuda",
        "source": "py21cmfast_torch/csrc/cic_deposit.cu",
        "replaces": "py21cmfast_tpu/ops/pallas_deposit.py:101",
        "launches": kernels[0]["launches_by_path"]["faithful_lightcone"],
        **row,
        "library_ms": None,  # no single PyTorch call computes a CIC deposit
    }


# phase 19: the fused Ts shell kernels at the benchmark's box, the latest
# template's ladder at z=25; the cases of tests/test_torch_ts_shell.py
TS_SHELL_N = 256
TS_SHELL_CASES = {
    "chebyshev": ("latest", {}, False),
    "gather": ("latest", {}, True),
    "const-zeta": ("const-zeta", {}, False),
    "no-lya-heating": ("latest", dict(USE_LYA_HEATING=False), False),
}
# bytes a cell a shell: delta0 read by both kernels, x_e read, each
# accumulator read and written
TS_SHELL_BYTES = {6: 4 + 8 + 48, 4: 4 + 8 + 32}


def ts_shell_phase():
    """Phase 19: the fused Ts shell kernels against the plain torch path at
    256^3 over the real 40-shell ladder, in four cases, then the timings of
    the whole scan on both paths and of the two kernels alone against their
    byte bound.  Returns the kernels line's row, with the launches each
    main path of the phases before made (TS_SHELL_BY_PATH)."""
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import heating
    from py21cmfast_torch.models import spintemp as tsp
    from py21cmfast_torch.ops import filters, grids, ts_shell

    n, dev = TS_SHELL_N, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dens = torch.exp(torch.randn((n,) * 3, generator=gen, device=dev) * 0.4 - 0.08) - 1.0
    xe = 10.0 ** (torch.rand((n,) * 3, generator=gen, device=dev) * 3.5 - 4.0)
    row, worst_of_cases = None, 0.0
    for case, (template, over, gather) in TS_SHELL_CASES.items():
        inputs = p21.InputParameters.from_template(template, random_seed=SEED).evolve_input_structs(
            **over)
        fit = tsp._fit_log_cheby
        if gather:
            tsp._fit_log_cheby = lambda t, c: (*fit(t, c)[:2], False)
        try:
            h = tsp.ts_host_tables(25.0, inputs, 25.0, 25.5, 2e-4)
        finally:
            tsp._fit_log_cheby = fit
        pack = tsp.packed_shells(h, dev)
        shells = tsp.shells_from_tables(h, dev)
        kw = dict(shape=(n,) * 3, box_lens=(inputs.simulation_options.box_len,) * 3,
                  heat_filter=inputs.astro_options.heat_filter_int, use_xray_heat=True,
                  use_lya_heat=h["use_lya_heat"], use_cheby=h["use_cheby"],
                  const_model=h["const_model"])
        args = (float(np.float32(h["consts"]["inv_growth_pf"])), float(np.float32(h["fstar10"])))

        def fused():
            return tsp._ts_shell_scan(dens, xe, pack, *args, **kw)

        def plain():
            return tsp._ts_shell_scan(dens, xe, shells, *args, **kw)

        got, again, ref = fused(), fused(), plain()
        names = tsp._accumulator_names(True, h["use_lya_heat"])
        errs = {}
        for name, g, a, r in zip(names, got, again, ref):
            if not torch.equal(g, a):
                raise AssertionError(f"[ts-shell] {case} {name}: two runs differ")
            errs[name] = float(torch.linalg.vector_norm((g - r).double())
                               / torch.linalg.vector_norm(r.double()))
        worst = max(errs.values())
        worst_of_cases = max(worst_of_cases, worst)
        print(f"[ts-shell] {case}: {len(pack)} shells at {n}^3, kernels vs plain relative L2 "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + "; two runs bit-identical")
        if not worst <= 1e-5:
            raise AssertionError(f"[ts-shell] {case}: relative L2 {worst:.3e} > 1e-5")
        del got, again, ref
        if case != "chebyshev":
            continue

        # the whole scan on both paths, in turns on this card
        fused_ms = _event_median_ms(fused, 5)
        plain_ms = _event_median_ms(plain, 3)
        fused_again_ms = _event_median_ms(fused, 5)
        # the two kernels alone over the ladder, each shell's filtered field
        # made beforehand
        d_k = torch.fft.rfftn(dens * args[0], dim=(0, 1, 2))
        kmag = grids.kmag_grid((n,) * 3, kw["box_lens"], dev)
        deltas = [filters.filter_kbox(d_k, kmag, kw["heat_filter"], c.R) if filtered else d_k
                  for c, filtered in zip(pack.consts, pack.do_filter)]
        deltas = [torch.fft.irfftn(d, s=(n,) * 3, dim=(0, 1, 2)) for d in deltas]
        del d_k, kmag
        accs = {k: torch.zeros_like(dens) for k in names}
        partials = ts_shell.partials_buffer(dens)
        m = ts_shell.mode(h["use_cheby"], h["const_model"])
        step = ts_shell.StepConsts(*args, tuple(heating.X_INT_XHII))

        def kernels_only():
            for i, d0 in enumerate(deltas):
                ts_shell.ts_shell_reduce(d0, step, pack.consts, i, m, None, partials)
                ts_shell.ts_shell_accumulate(d0, xe, accs, step, pack.consts, i, m, None,
                                             partials, use_xray_heat=True,
                                             use_lya_heat=h["use_lya_heat"])

        kernels_ms = _event_median_ms(kernels_only, 5)
        n_bytes = TS_SHELL_BYTES[len(names)] * dens.numel() * len(pack)
        bound_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
        print(f"[ts-shell] latest z=25 Ts step at {n}^3, {len(pack)} shells: whole scan fused "
              f"{fused_ms:.3f} and {fused_again_ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events, "
              f"medians of 5, 3, 5); the two kernels alone {kernels_ms:.3f} ms over the "
              f"{len(pack)} shells ({2 * len(pack)} launches), bound {bound_ms:.3f} ms "
              f"({n_bytes / 1e9:.3f} GB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s), "
              f"{100 * bound_ms / kernels_ms:.1f}% of it")
        del deltas, accs
        row = {
            "name": "ts_shell_reduce+ts_shell_accumulate",
            "shape": f"{n}^3 x {len(pack)} shells",
            "route": "cuda",
            "source": "py21cmfast_torch/csrc/ts_shell.cu",
            "replaces": None,  # the JAX package's _ts_shell_scan is XLA
            "launches": sum(TS_SHELL_BY_PATH.values()),
            "launches_by_path": dict(TS_SHELL_BY_PATH),
            "ms": kernels_ms,
            "kernel_ms": kernels_ms,
            "scan_fused_ms": min(fused_ms, fused_again_ms),
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": None,  # no single PyTorch call computes the chain
        }
    row["max_rel_l2"] = worst_of_cases  # of the four cases
    torch.cuda.empty_cache()
    print(f"[ts-shell] launches of the two kernels by main path, each read just after its run: "
          f"{TS_SHELL_BY_PATH}")
    return row


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this check runs only on an NVIDIA GPU")
    import py21cmfast_torch  # noqa: F401  (fails outside a checkout of the repository)

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
        scroll_phase(kernels)
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
        torch.cuda.empty_cache()
        kernels.append(faithful_phase(kernels))
        kernels.append(ts_shell_phase())
    finally:
        if cpu_global[0].is_alive():
            cpu_global[0].terminate()
        cpu_global[0].join()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
