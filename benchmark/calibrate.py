#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... --control-seeds 11 12 13

For each seed: the program's ICs and one cone through the timed path's own
code (`harness.loop.run_cone`), then the reference's ICs and cone, and the
relative L2 gap of every compared output (`harness.compare`): the lower
readings.  For each control seed, besides: the control, the reference with
every stage's output in bfloat16, against the reference: the upper
readings.  One JSON line a seed, then a summary line: for each number the
largest program reading and the smallest control reading.  The limits in
`limits/<workload>.toml` are set between the two (see README.md).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
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
    cell = cells.resolve(args.workload)
    lines = []

    def emit(obj):
        line = json.dumps({k: (str(v) if isinstance(v, float) and not math.isfinite(v) else v)
                           for k, v in obj.items()})
        print(line, flush=True)
        lines.append(line)

    lower, upper = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed}
        ref_ics = reference.initial_conditions(cell, seed, dev)
        if seed in args.seeds:
            inputs = cells.build_inputs(p21.InputParameters, cell, seed)
            ics = p21.compute_initial_conditions(inputs, device=dev)
            lc, nodes, launches, finite = loop.run_cone(p21, cell, inputs, ics, dev)
            prog = {"ics": compare.ics_reading(ics, ref_ics)}
            del ics
            prog_cones = dict(lc.lightcones)
            del lc
            row.update(nodes=nodes, launches=launches, finite=bool(finite))
        torch.cuda.empty_cache()
        ref_cones = reference.cone(cell, seed, ref_ics, dev)
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
            ctl_cones = reference.cone(cell, seed, ctl_ics, dev, precision="bfloat16")
            del ctl_ics
            ctl.update(compare.cone_readings(ctl_cones, ref_cones))
            del ctl_cones
            row["control"] = ctl
            for k, v in ctl.items():
                upper[k] = min(upper.get(k, math.inf), v)
        ref_ics = ref_cones = None
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        emit(row)
    emit({"workload": args.workload, "summary": {
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
