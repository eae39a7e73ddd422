#!/usr/bin/env python3
"""Benchmark of py21cmfast_torch on one NVIDIA GPU: the port's counterpart of
bench.py, measuring the same lightcones end to end.

Baseline (BASELINE.md / JOSS v3 paper, as bench.py states it): the reference
21cmFAST C code runs the full z=5-35 lightcone (92 nodes, USE_TS_FLUCT +
INHOMO_RECO, HII_DIM=250, DIM=1000, i.e. DIM = 4 x HII_DIM) in 7.63 hr =
27468 s on a 16-core Xeon.  That is a CPU time of the reference C code; no
accelerator's number is a baseline here.

Segments, each in a process of its own (`--segment NAME`):
  full768      HII_DIM=256, DIM=768, BOX_LEN=384, MINIMIZE_MEMORY off
  full1024     HII_DIM=256, DIM=1024: the reference's own 4x resolution
               ratio, with MINIMIZE_MEMORY on (bench.py's rule)
  fallback128  HII_DIM=128, DIM=384, against the baseline scaled by
               (128/250)^3
each with bench.py's physics: E-INTEGRAL sources, USE_TS_FLUCT,
inhomogeneous recombinations, R_BUBBLE_MAX=50, 92 nodes of
ZPRIME_STEP_FACTOR=1.02 from Z_HEAT_MAX=35 to z=5, the velocity-gradient
correction and RSDs.  A segment times the ICs' first call, every node of
`generate_lightcone`, and the finalization, every window ending on
torch.cuda.synchronize(); it prints a projection line after every node from
the third and its measured line last.  The CUDA kernels are built before the
clock starts (`build_s`).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 bench_torch.py                      # full768, then full1024
    python3 bench_torch.py --segment full1024   # one segment, in this process
    python3 bench_torch.py --trace              # per-layer spans of full768
    python3 bench_torch.py --trace --segment full1024
    python3 bench_torch.py --seed 5             # another realization (default 3)

Without --segment the last line is one banked JSON object (metric, value,
unit, vs_baseline, detail); the exit code is non-zero if a segment failed.
--trace is a separate run for the per-layer numbers: spans around the calls
into each layer, each between two synchronisations, the host
synchronisations of every node (torch.cuda.set_sync_debug_mode) and a
torch.profiler window over the three nodes nearest z=8.  Its wall is not an
end-to-end number.  Without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

BASELINE_S = 27468.0
SEGMENTS = ("full768", "full1024", "fallback128")
# (z_min, Z_HEAT_MAX, ZPRIME_STEP_FACTOR): bench.py's 92 nodes from z=35.37 to 5
LADDER = (5.0, 35.0, 1.02)
# projections only: the finalization (dvdr + RSDs) of the 256^3 headline took
# 0.05-0.17 s on an H100 (chip_smoke.py phase 9); a projection counts 1 s
FINALIZE_EST_S = 1.0
SEGMENT_TIMEOUT_S = 1200.0
# H100 SXM HBM3 bytes/s (NVIDIA data sheet), for the deposit's byte bound
PEAK_BYTES_PER_S = 3.35e12
TRACE_Z = 8.0


def card():
    """The card as nvidia-smi names it, its power limit and the device count."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"card": smi, "device_count": torch.cuda.device_count()}


def _headline_inputs(hii_dim, dim, seed, z_min, z_max, zprime):
    """bench.py's _headline_inputs, field for field, for the port."""
    import py21cmfast_torch as p21

    return p21.InputParameters(random_seed=seed).evolve_input_structs(
        HII_DIM=hii_dim,
        DIM=dim,
        BOX_LEN=1.5 * hii_dim,
        SOURCE_MODEL="E-INTEGRAL",
        USE_TS_FLUCT=True,
        RECOMB_MODEL="inhomogeneous",
        R_BUBBLE_MAX=50.0,
        USE_EXP_FILTER=False,
        CELL_RECOMB=False,
        Z_HEAT_MAX=z_max,
        ZPRIME_STEP_FACTOR=zprime,
        MINIMIZE_MEMORY=(dim >= 4 * hii_dim),
    ).with_logspaced_redshifts(z_min)


def _projection_line(tag, t_ics, node_times, n_nodes, baseline=BASELINE_S):
    """One banked-projection JSON line from a measured prefix of the scroll."""
    import numpy as np

    steady = node_times[3:] if len(node_times) > 6 else node_times
    med = float(np.median(steady))
    projected = t_ics + med * n_nodes + FINALIZE_EST_S
    print(json.dumps({
        "metric": f"ts_recomb_lightcone_projected_{tag}_seconds",
        "value": projected,
        "unit": "s",
        "vs_baseline": baseline / projected,
        "detail": {
            "kind": "projected",
            "t_ics_s": t_ics,
            "nodes_measured": len(node_times),
            "n_nodes": n_nodes,
            "node_median_s": med,
            "finalize_est_s": FINALIZE_EST_S,
        },
    }), flush=True)


def run_full_lightcone(hii_dim=256, dim=768, seed=3, stream_tag=None, baseline=BASELINE_S, *,
                       device="cuda", ladder=LADDER, lightconer=None, trace=None):
    """The measured lightcone: the ICs' first call, every node of
    generate_lightcone(..., apply_rsds=True), the finalization.  Returns
    bench.py's keys, with the peak device memory and the deposit launches
    on the card, and the finished LightCone under "lightcone".

    `stream_tag` prints a projection line after every node from the third;
    `ladder` is (z_min, Z_HEAT_MAX, ZPRIME_STEP_FACTOR); `lightconer` is
    handed to generate_lightcone; `trace` (a LayerTrace) runs each node."""
    import numpy as np
    import torch

    import py21cmfast_torch as p21
    from py21cmfast_torch.models import ics as ics_module
    from py21cmfast_torch.ops import deposit

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    inputs = _headline_inputs(hii_dim, dim, seed, *ladder)
    nodes = list(inputs.node_redshifts)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    launches = deposit.cic_deposit_swept.launches

    sync()
    t0 = time.perf_counter()
    ics = ics_module.compute_initial_conditions(inputs, device=dev)
    sync()
    t_ics = time.perf_counter() - t0
    steps = p21.generate_lightcone(inputs, lightconer=lightconer, initial_conditions=ics,
                                   apply_rsds=True, device=dev)
    del ics
    node_times, lc = [], None
    t_prev = time.perf_counter()
    for i in range(len(nodes) + 1):
        step = next(steps) if trace is None else trace.run_node(i, nodes, lambda: next(steps))
        sync()
        z, lc = step[0], step[2]
        del step
        if z is None:
            break
        now = time.perf_counter()
        node_times.append(now - t_prev)
        t_prev = now
        if stream_tag and len(node_times) >= 3:
            _projection_line(stream_tag, t_ics, node_times, len(nodes), baseline=baseline)
    total = time.perf_counter() - t0
    launches = deposit.cic_deposit_swept.launches - launches

    if len(node_times) != len(nodes):
        raise AssertionError(f"{len(node_times)} nodes yielded of {len(nodes)}")
    if on_card and launches != len(nodes):
        raise AssertionError(f"{launches} deposit launches in {len(nodes)} nodes")
    for q, t in lc.lightcones.items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"the {q} lightcone is not finite")
    return {
        "total_s": total,
        "t_ics_s": t_ics,
        "n_nodes": len(nodes),
        "node_median_s": float(np.median(node_times)),
        "node_p90_s": float(np.percentile(node_times, 90)),
        "finalize_s": total - t_ics - float(np.sum(node_times)),
        "global_xh_end": float(lc.global_quantities["neutral_fraction"][-1]),
        "node_min_s": float(np.min(node_times)),
        "node_max_s": float(np.max(node_times)),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        "deposit_launches": launches,
        "lightcone": lc,
    }


def measured_line(tag, result, baseline=BASELINE_S, kind="measured", extra=None):
    """The banked JSON object of a measured run (the LightCone left out)."""
    stats = {k: v for k, v in result.items() if k != "lightcone"}
    return {
        "metric": f"ts_recomb_lightcone_measured_{tag}_seconds",
        "value": result["total_s"],
        "unit": "s",
        "vs_baseline": baseline / result["total_s"],
        "detail": {"kind": kind, **stats, **(extra or {})},
    }


class LayerTrace:
    """The per-layer record of one traced lightcone (--trace).

    Spans: the calls into each layer, wrapped where py21cmfast_torch's
    drivers look them up (as chip_smoke.py wraps them), each between two
    synchronisations, with the node that made it.  Host synchronisations: every node's, counted by
    torch.cuda.set_sync_debug_mode("warn") by the source line that made
    them (this file's own synchronisations left out).  A torch.profiler
    window over the three nodes nearest TRACE_Z: device time by kernel, the
    device's idle share of the window and its longest idle gaps."""

    def __init__(self):
        self.spans = []  # (layer, node index, seconds)
        self.syncs = {}  # node index -> Counter of source lines
        self.node = None
        self.window = None

    def _span(self, layer, fn):
        import torch

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.spans.append((layer, self.node, time.perf_counter() - t0))
        return run

    @contextlib.contextmanager
    def installed(self):
        """Wrap each layer's entry where the drivers call it."""
        from py21cmfast_torch import lightconers, rsds
        from py21cmfast_torch.drivers import coeval
        from py21cmfast_torch.models import ics, ionization, perturb, spintemp

        targets = [
            (ics, "compute_initial_conditions", "ICs"),
            (perturb, "perturb_field", "perturb"),
            (spintemp, "compute_spin_temperature", "Ts"),
            (ionization, "compute_ionization_field", "ionize"),
            (coeval, "brightness_temperature", "Tb"),
            (lightconers.RectilinearLightconer, "make_lightcone_slices", "lightcone slices"),
            (rsds, "include_dvdr_in_tau21", "dvdr"),
            (rsds, "apply_rsds", "RSDs"),
        ]
        saved = [(obj, attr, obj.__dict__.get(attr)) for obj, attr, _ in targets]
        for obj, attr, layer in targets:
            setattr(obj, attr, self._span(layer, getattr(obj, attr)))
        try:
            yield self
        finally:
            for obj, attr, fn in saved:
                if fn is None:
                    delattr(obj, attr)
                else:
                    setattr(obj, attr, fn)

    def run_node(self, i, nodes, fn):
        """Node i (i == len(nodes): the finalization) through `fn`."""
        import numpy as np
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.node = i
        centre = int(np.argmin(np.abs(np.asarray(nodes) - TRACE_Z)))
        if i == centre - 1:
            self.window = {"nodes": [], "prof": profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])}
            self.window["prof"].start()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        here = os.path.abspath(__file__)
        self.syncs[i] = collections.Counter(
            f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message) and os.path.abspath(w.filename) != here)
        if self.window is not None and "wall_s" not in self.window:
            self.window["nodes"].append((i, float(nodes[i]), time.perf_counter() - t0))
            if i == centre + 1:
                self.window["prof"].stop()
                self.window["wall_s"] = sum(s for _, _, s in self.window["nodes"])
        return out

    def _device_window(self, deposit_bound_ms):
        """Kernel time by name, the idle share and the longest idle gaps of
        the profiled window, from the device events the profiler recorded."""
        from torch.autograd import DeviceType

        prof = self.window.pop("prof")
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.device_type == DeviceType.CUDA)
        wall_ms = 1e3 * self.window["wall_s"]
        if not spans:
            return {"nodes": self.window["nodes"], "wall_ms": wall_ms,
                    "device": "not measured: the profiler recorded no device activity"}
        by_name = collections.defaultdict(lambda: [0.0, 0])
        busy, end, gaps, last = 0.0, spans[0][0], [], spans[0][2]
        for s, e, name in spans:
            if s > end:
                gaps.append(((s - end) / 1e3, last[:70], name[:70]))
            busy += max(0.0, e - max(s, end))
            if e > end:
                end, last = e, name
            by_name[name][0] += (e - s) / 1e3
            by_name[name][1] += 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        dep = [(ms, n) for name, (ms, n) in by_name.items() if "cic_deposit" in name]
        dep_ms = sum(ms for ms, _ in dep) / max(1, sum(n for _, n in dep))
        return {
            "nodes": self.window["nodes"],
            "wall_ms": wall_ms,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
            "kernel_launches": len(spans),
            "top_kernels_ms": [(name[:90], ms, n) for name, (ms, n) in top],
            "longest_idle_gaps_ms": sorted(gaps, reverse=True)[:8],
            "deposit_kernel_ms": dep_ms if dep else None,
            "deposit_bound_share": deposit_bound_ms / dep_ms if dep else None,
        }

    def report(self, inputs, n_nodes):
        """Per-layer numbers: seconds a node (median, total) of each layer
        inside the scroll, the ICs and the finalization's steps, host
        synchronisations a node, the profiled window."""
        import numpy as np

        so = inputs.simulation_options
        per = collections.defaultdict(dict)
        for layer, node, s in self.spans:
            per[layer][node] = per[layer].get(node, 0.0) + s
        layers = {}
        for layer, by_node in per.items():
            in_scroll = [s for n, s in by_node.items() if n is not None and n < n_nodes]
            layers[layer] = {
                "total_s": float(sum(by_node.values())),
                "calls_in": len(by_node),
                "median_per_node_s": float(np.median(in_scroll)) if in_scroll else None,
            }
        counts = [sum(self.syncs[i].values()) for i in range(n_nodes) if i in self.syncs]
        lines = collections.Counter()
        for i in range(n_nodes):
            lines.update(self.syncs.get(i, {}))
        deposit_bytes = 4 * so.DIM**3 + 4 * 4 * so.HII_DIM**3
        bound_ms = 1e3 * deposit_bytes / PEAK_BYTES_PER_S
        return {
            "layers": layers,
            "host_syncs_per_node": {"median": float(np.median(counts)), "min": min(counts),
                                    "max": max(counts),
                                    "by_line": dict(lines.most_common(12))},
            "deposit_bytes": deposit_bytes,
            "deposit_bound_ms": bound_ms,
            "window": self._device_window(bound_ms),
        }


def _segment_args(segment):
    if segment == "fallback128":
        return 128, 384, BASELINE_S * (128 / 250) ** 3
    return 256, (1024 if segment == "full1024" else 768), BASELINE_S


def _segment_main(segment, seed, trace=False):
    from py21cmfast_torch import _kernels

    t0 = time.perf_counter()
    _kernels.build()
    build_s = time.perf_counter() - t0
    hii_dim, dim, baseline = _segment_args(segment)
    tag = f"hii{hii_dim}_dim{dim}"
    info = {**card(), "seed": seed, "build_s": build_s}
    if trace:
        tracer = LayerTrace()
        with tracer.installed():
            result = run_full_lightcone(hii_dim, dim, seed, baseline=baseline, trace=tracer)
        inputs = result["lightcone"].inputs
        print(json.dumps({"trace": {
            "segment": segment, **info, "traced_total_s": result["total_s"],
            **tracer.report(inputs, result["n_nodes"])}}, default=str), flush=True)
        return
    result = run_full_lightcone(hii_dim, dim, seed, stream_tag=tag, baseline=baseline)
    kind = "measured_fallback" if segment == "fallback128" else "measured"
    print(json.dumps(measured_line(tag, result, baseline, kind, {
        "config": f"{tag}_z5-35_ts_recomb_rsds_measured", **info})), flush=True)


def _run_segment_subprocess(segment, seed, timeout_s=SEGMENT_TIMEOUT_S):
    """One segment in a fresh process; its last JSON line, or an error."""
    try:
        r = subprocess.run(
            [sys.executable, __file__, "--segment", segment, "--seed", str(seed)],
            capture_output=True, text=True, timeout=timeout_s, cwd=str(Path(__file__).parent))
    except subprocess.TimeoutExpired:
        return {"error": f"segment timeout after {timeout_s:.0f}s"}
    if r.returncode != 0:
        tail = r.stderr.strip().splitlines()
        return {"error": (f"rc={r.returncode}: " + (tail[-1] if tail else "no output"))[:300]}
    for line in reversed(r.stdout.splitlines()):
        if line.startswith("{"):
            with contextlib.suppress(json.JSONDecodeError):
                return json.loads(line)
    return {"error": "no parseable line"}


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--segment", choices=SEGMENTS)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--trace", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_torch: no CUDA device is available; this benchmark runs only on an "
                 "NVIDIA GPU (an H100)")
    if args.trace or args.segment:
        _segment_main(args.segment or "full768", args.seed, trace=args.trace)
        return
    # both segments in turn: 80 GB holds either
    runs = {s: _run_segment_subprocess(s, args.seed) for s in ("full768", "full1024")}
    failed = {f"{s}_error": r["error"] for s, r in runs.items() if "error" in r}
    if "full1024_error" not in failed:
        banked = runs["full1024"]
        if "full768_error" not in failed:
            banked["detail"]["dim768"] = {"value": runs["full768"]["value"],
                                          **runs["full768"]["detail"]}
    elif "full768_error" not in failed:
        banked = runs["full768"]
    else:
        banked = {"metric": "bench_failed", "value": 0, "unit": "s", "vs_baseline": 0,
                  "detail": {}}
    banked["detail"].update(failed)
    print(json.dumps(banked))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
