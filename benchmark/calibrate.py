#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... --control-seeds 11 12 13
    python3 benchmark/calibrate.py --config configs/<name>.toml --traffic <mix> --seeds ...

For each seed: the program's ICs and one cone through the timed path's own
code (`harness.loop.run_cone`), then the reference's ICs and cone, and the
relative L2 gap of every compared output (`harness.compare`): the lower
readings.  For each control seed, besides: the control, the reference with
every stage's output in bfloat16, against the reference: the upper
readings.  Where the configuration samples halos, the reference and the
control take the cone's catalogs, and the row also holds the catalog
gate's numbers beside their limits, the halos of each node and the bytes
of the catalogs waiting on the host.  One JSON line a seed (with the
cone's seconds and the card's peak over it), then a summary line: for each number
the largest program reading and the smallest control reading.  The limits
in `limits/<workload>.toml` are set between the two (see README.md).
`--config` and `--traffic` read a configuration and a traffic mix that no
cell names yet.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", help="a cell of BENCHMARK.json")
    p.add_argument("--config", help="instead of a cell: a configuration file under benchmark/")
    p.add_argument("--traffic", help="with --config: the name of a traffic mix")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None, help="also write the lines to this file")
    args = p.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(BENCH_DIR.parent))
    import torch

    from harness import cells, compare, loop, reference

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    import py21cmfast_torch as p21
    from py21cmfast_torch import _kernels

    _kernels.build()
    dev = torch.device("cuda", 0)
    if args.config:
        cell = cells.from_files(BENCH_DIR / args.config, args.traffic)
    else:
        cell = cells.resolve(args.workload)
    name = cell.name
    matter = cells.build_inputs(p21.InputParameters, cell, 0).matter_options
    samples = matter.source_model_uses_halo_sampler
    lines = []

    def emit(obj):
        line = json.dumps({k: (str(v) if isinstance(v, float) and not math.isfinite(v) else v)
                           for k, v in obj.items()})
        print(line, flush=True)
        lines.append(line)

    lower, upper = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        row = {"workload": name, "seed": seed}
        ref_ics = reference.initial_conditions(cell, seed, dev)
        catalogs = None
        if seed in args.seeds or samples:
            inputs = cells.build_inputs(p21.InputParameters, cell, seed)
            ics = p21.compute_initial_conditions(inputs, device=dev)
            book = {}
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize(dev)
            t_cone = time.perf_counter()
            with loop.host_catalogs(book) if samples else contextlib.nullcontext():
                lc, nodes, launches, finite = loop.run_cone(p21, cell, inputs, ics, dev)
            torch.cuda.synchronize(dev)
            row.update(cone_s=time.perf_counter() - t_cone,
                       cone_peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            prog = {"ics": compare.ics_reading(ics, ref_ics)}
            del ics
            prog_cones = dict(lc.lightcones)
            del lc
            row.update(nodes=nodes, launches=launches, finite=bool(finite))
            if samples:
                catalogs = reference.catalogs_of(book)
                del book
                row["halos"] = {f"{z:.4f}": c.n_halos for z, c in sorted(catalogs.items())}
                row["catalog_bytes"] = sum(t.numel() * t.element_size() for c in catalogs.values()
                                           for t in (c.halo_masses, c.halo_coords, c.star_rng,
                                                     c.sfr_rng, c.xray_rng))
                row["gate"] = reference.gate(cell, seed, catalogs, ref_ics)
            if seed not in args.seeds:  # a control seed: the cone gave its catalogs
                del prog_cones
        torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref_cones = reference.cone(cell, seed, ref_ics, dev, catalogs=catalogs)
        row["reference_s"] = time.perf_counter() - t_ref
        if seed in args.seeds:
            prog.update(compare.cone_readings(prog_cones, ref_cones))
            del prog_cones
            row["program"] = prog
            for k, v in prog.items():
                lower[k] = max(lower.get(k, 0.0), v)
        if seed in args.control_seeds:
            ctl_ics = reference.initial_conditions(cell, seed, dev, precision="bfloat16")
            ctl = {"ics": compare.ics_reading(ctl_ics, ref_ics)}
            del ref_ics
            torch.cuda.empty_cache()
            ctl_cones = reference.cone(cell, seed, ctl_ics, dev, precision="bfloat16",
                                       catalogs=catalogs)
            del ctl_ics
            ctl.update(compare.cone_readings(ctl_cones, ref_cones))
            del ctl_cones
            row["control"] = ctl
            for k, v in ctl.items():
                upper[k] = min(upper.get(k, math.inf), v)
        ref_ics = ref_cones = catalogs = None
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        emit(row)
    emit({"workload": name, "summary": {
        k: {"lower": lower.get(k), "upper": upper.get(k),
            "ratio": (upper[k] / lower[k]) if lower.get(k) and k in upper else None}
        for k in sorted(set(lower) | set(upper))},
        "seeds": args.seeds, "control_seeds": args.control_seeds,
        "card": torch.cuda.get_device_name(dev)})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
