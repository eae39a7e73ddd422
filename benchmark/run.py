#!/usr/bin/env python3
"""The benchmark of py21cmfast_torch: one run of one cell on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds BENCHMARK.json, this folder and
the program.  The cell (an entry of BENCHMARK.json's `workloads`) names its
configuration and traffic files; `harness/loop.py` says what set-up, the
window and the comparison are.  The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number beside its limit; the
same numbers are the last lines of standard error.

Without a CUDA device, with fewer devices than the cell asks for, without
the program, or with JAX loaded once the window has closed, it prints no
result and exits non-zero.  It never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "py21cmfast_tpu")


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = BENCH_DIR.parent / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def forbidden_modules() -> list[str]:
    """Modules of JAX or the JAX package loaded in this process, compared by
    whole top-level name."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(obj):
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _cache_dirs()
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(BENCH_DIR.parent))
    import torch

    from harness import cells, loop

    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is available; the benchmark runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} are available", file=sys.stderr)
        return 3
    try:
        import py21cmfast_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program py21cmfast_torch is not here: {e}", file=sys.stderr)
        return 3

    result, lines = loop.run(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(_finite(result)), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
