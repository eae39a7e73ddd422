"""One run of a cell: set-up, the measured window, the comparison.

Set-up (`setup_s`, from the process's start): the program's import and its
kernels' build (served from the checkout after the first run), the cell's
inputs, `reset_peak_memory_stats`, the ICs from the seed, and one warm-up
cone of the cell's own traffic, which warms every shape, FFT plan and host
table the window uses.

The window is a closed loop of whole lightcones from those ICs: each cone
runs `generate_lightcone` to its final yield (dvdr and RSDs applied), the
harness synchronises at its end, and the next starts.  No cone starts once
`seconds` have passed; the window ends with the last cone started.  A cone
fails unless it yields every node, makes one deposit launch a node (on the
card) and comes out finite.  `lightcone_s` is the window's seconds over its
cones; `peak_gib` is max_memory_allocated from before the ICs to the
window's end.

After the window one of its cones, drawn from the seed, is compared with the
reference (`reference.py`) by `compare.py`.
"""

from __future__ import annotations

import contextlib
import random
import sys
import time
import traceback

from . import card, cells, compare, reference


def _launches():
    from py21cmfast_torch.ops import deposit

    return deposit.cic_deposit_swept.launches


def run_cone(p21, cell, inputs, ics, dev, tracer=None):
    """One whole cone through the program.  Returns (LightCone, nodes
    yielded, deposit launches, device flag of a finite cone)."""
    import torch

    use_ts = inputs.astro_options.USE_TS_FLUCT
    z = inputs.node_redshifts
    lightconer = p21.RectilinearLightconer.with_equal_cdist_slices(
        min_redshift=float(min(z)), max_redshift=float(max(z)), inputs=inputs,
        quantities=cells.lightcone_quantities(cell, use_ts))
    launches0 = _launches()
    steps = p21.generate_lightcone(
        inputs, lightconer=lightconer, initial_conditions=ics,
        include_dvdr_in_tau21=bool(cell.traffic["include_dvdr_in_tau21"]),
        apply_rsds=bool(cell.traffic["apply_rsds"]), device=dev)
    if tracer is not None:
        tracer.begin_cone(len(z))
    nodes = 0
    while True:
        if tracer is not None:
            tracer.begin_step(nodes if nodes < len(z) else None)
        zi, coeval, lc = next(steps)
        del coeval
        if tracer is not None:
            tracer.end_step()
        if zi is None:
            break
        nodes += 1
    steps.close()
    finite = torch.stack([torch.isfinite(t).all() for t in lc.lightcones.values()]).all()
    return lc, nodes, _launches() - launches0, finite


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        overrides: dict | None = None):
    """The result object of one run and the comparison's lines for stderr."""
    import torch

    import py21cmfast_torch as p21

    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    if on_card:
        from py21cmfast_torch import _kernels

        _kernels.build()
    inputs = cells.build_inputs(p21.InputParameters, cell, seed, overrides)
    n_nodes = len(inputs.node_redshifts)
    if on_card:
        torch.empty(1, device=dev)  # the allocator's stats exist once it has a context
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    ics = p21.compute_initial_conditions(inputs, device=dev)
    sync()
    ics_s = time.perf_counter() - t0
    warm = run_cone(p21, cell, inputs, ics, dev)
    sync()
    del warm

    tracer = None
    if trace:
        from .tracing import Tracer

        tracer = Tracer(dev)
    rng = random.Random(int(seed))
    kept, kept_at, flags, failed, attempted, crashed = None, None, [], 0, 0, False
    cone_s = []
    sync()
    window_start = time.perf_counter()
    setup_s = window_start - t_start
    with tracer.installed() if tracer else contextlib.nullcontext():
        while attempted == 0 or time.perf_counter() - window_start < seconds:
            attempted += 1
            t_cone = time.perf_counter()
            try:
                lc, nodes, launches, finite = run_cone(p21, cell, inputs, ics, dev, tracer)
            except Exception:  # a cone that raises has failed; the window ends
                traceback.print_exc()
                failed += 1
                crashed = True
                break
            sync()
            cone_s.append(time.perf_counter() - t_cone)
            if nodes != n_nodes or (on_card and launches != n_nodes):
                print(f"cone {attempted}: {nodes} nodes of {n_nodes}, "
                      f"{launches} deposit launches", file=sys.stderr)
                failed += 1
            flags.append(finite)
            if rng.random() < 1.0 / attempted:  # one cone, drawn from the seed
                kept, kept_at = lc, attempted
            del lc
    window_s = time.perf_counter() - window_start
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    failed += sum(1 for f in flags if not bool(f))
    completed = attempted - (1 if crashed else 0)

    record = tracer.record(ics_s, inputs.simulation_options.DIM,
                           inputs.simulation_options.HII_DIM) if tracer else None

    # ----- the comparison, once the window has closed -----
    checks, correct = {}, False
    t_ref = time.perf_counter()
    if kept is not None:
        prog_cones = dict(kept.lightcones)
        del kept
        ref_ics = reference.initial_conditions(cell, seed, dev, overrides)
        readings = {"ics": compare.ics_reading(ics, ref_ics)}
        del ics
        if on_card:
            torch.cuda.empty_cache()
        ref_cones = reference.cone(cell, seed, ref_ics, dev, overrides)
        del ref_ics
        readings.update(compare.cone_readings(prog_cones, ref_cones))
        del prog_cones, ref_cones
        correct, checks = compare.judge(readings, cell.limits)
    correct = correct and failed == 0
    reference_s = time.perf_counter() - t_ref

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.read_metric(m["name"], record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {
            "lightcone_s": window_s / completed if completed else None,
            "peak_gib": peak / 2**30 if on_card else None,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    device = card.device_record(dev, cell.chips, peak)
    if trace and record["window"] is not None:
        w = record["window"]
        device["window_s"] = w["window_s"]
        if "busy_s" in w:
            device["busy_s"] = w["busy_s"]
    result = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device,
    }
    if trace and record["window"] is not None and "device_ops" in record["window"]:
        result["breakdown"] = {"device_ops": record["window"]["device_ops"],
                               "idle_gaps": record["window"]["idle_gaps"]}
    result["info"] = {"seed": int(seed), "cone_compared": kept_at, "ics_s": ics_s,
                      "window_s": window_s, "cone_s": cone_s, "nodes": n_nodes,
                      "reference_s": reference_s, "run_s": time.perf_counter() - t_start}
    result["checks"] = checks
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
    if not checks:
        lines.append("check: no cone to compare")
    return result, lines

