"""Cells whose cones scroll the whole ladder above their band, because the
physics carries a history (`cells.carries_history`): `latest-eor`, the HERA
band of `latest` cones scrolled from Z_HEAT_MAX.

The ladder's split into the scroll's nodes and the band's, the same in the
program's inputs and the reference's; the short warm-up; the profiler
window and the readers inside the band; the harness's whole traced run of
the cell on the CPU at a tiny box against the reference; and that the cells
whose band is their ladder keep their ladders, bands and warm-up as they
were."""

import json
import math
import shutil
import time

import pytest
import torch
from conftest import BENCH_DIR, SEED, TINY

from harness import cells, loop
from harness.tracing import Tracer

CPU = torch.device("cpu")
WORKLOAD = "latest-eor"
# metrics that read only on the card: the profiler's device window, and the
# counter of the Ts shell kernels, which run on CUDA alone
CARD_ONLY = {"device.idle_pct", "device.kernels_per_node", "deposit.roofline_pct",
             "ts.kernel_shells_per_node", "ics.peak_gib"}


def _input_classes():
    import py21cmfast_torch as p21
    import ref21cm

    return {"program": p21.InputParameters, "reference": ref21cm.InputParameters}


@pytest.mark.parametrize("side", ["program", "reference"])
def test_the_ladder_splits_into_the_chain_and_the_band(side):
    """84 nodes from z = 35.22; the cone's slices span the last 33, the `eor`
    traffic's own ladder, and the warm-up runs the lowest 3."""
    cls = _input_classes()[side]
    cell = cells.resolve(WORKLOAD)
    inputs = cells.build_inputs(cls, cell, SEED)
    nodes = tuple(inputs.node_redshifts)
    assert len(nodes) == 84 and math.isclose(nodes[0], 35.21698525173924)
    band = cells.band_nodes(cell, inputs)
    eor = cells.build_inputs(cls, cells.resolve("simple-eor"), SEED).node_redshifts
    assert band == tuple(eor) == nodes[-33:]
    assert math.isclose(band[0], 12.191784144707917) and band[-1] == 6.0
    warm = cells.warmup_inputs(cell, inputs)
    assert tuple(warm.node_redshifts) == nodes[-3:]
    assert cells.band_nodes(cell, warm) == nodes[-3:]
    assert warm.simulation_options == inputs.simulation_options


@pytest.mark.parametrize("workload,history", [("latest-dawn", True), ("simple-eor", False),
                                              ("faithful-dawn", True), ("latest-eor", True)])
def test_the_physics_says_whether_a_chain_carries_a_history(workload, history):
    for cls in _input_classes().values():
        inputs = cells.build_inputs(cls, cells.resolve(workload), SEED)
        assert cells.carries_history(inputs) is history


@pytest.mark.parametrize("workload", ["latest-dawn", "simple-eor", "faithful-dawn"])
def test_cells_whose_band_is_their_ladder_keep_it(workload):
    """The dawn bands reach Z_HEAT_MAX; simple-eor's physics has no history."""
    import py21cmfast_torch as p21

    cell = cells.resolve(workload)
    inputs = cells.build_inputs(p21.InputParameters, cell, SEED)
    z_min, z_max = cells.cone_band(cell, inputs.simulation_options.Z_HEAT_MAX)
    assert tuple(inputs.node_redshifts) == tuple(
        inputs.with_logspaced_redshifts(z_min, z_max).node_redshifts)
    assert cells.band_nodes(cell, inputs) == tuple(inputs.node_redshifts)
    assert cells.warmup_inputs(cell, inputs) is inputs


def test_a_band_off_the_ladder_is_refused():
    import py21cmfast_torch as p21

    cell = cells.resolve(WORKLOAD)
    inputs = cells.build_inputs(p21.InputParameters, cell, SEED)
    shifted = inputs.with_logspaced_redshifts(6.01, 35.0)
    with pytest.raises(ValueError, match="do not end the ladder"):
        cells.band_nodes(cell, shifted)


def test_the_record_holds_the_band_alone():
    """Spans, steps and syncs of the nodes above the band are left out; the
    finalization's spans stay."""
    tracer = Tracer(CPU)
    tracer.begin_cone(5, first=3)
    for node in range(5):
        tracer.spans.append(("ionize", 0, node, 1.0 + node))
        tracer.steps.append((0, node, 10.0 + node, node))
    tracer.spans.append(("RSDs", 0, None, 0.5))
    tracer.steps.append((0, None, 0.25, 7))
    record = tracer.record(1.0, 6, 2)
    assert (record["band_first"], record["nodes"]) == (3, 2)
    assert record["layer_s"] == {"ionize": 4.0 + 5.0, "RSDs": 0.5}
    assert (record["node_wall_s"], record["node_stage_s"]) == (13.0 + 14.0, 9.0)
    assert record["node_host_syncs"] == 3 + 4


def test_the_profiler_window_lies_in_the_band():
    tracer = Tracer(CPU)
    tracer.begin_cone(84, first=51)
    assert (tracer.profile["first"], tracer.profile["last"]) == (66, 68)
    whole = Tracer(CPU)
    whole.begin_cone(24)
    assert (whole.profile["first"], whole.profile["last"]) == (11, 13)


def test_the_cell_is_latest_cut_to_z6():
    cell = cells.resolve(WORKLOAD)
    latest = cells.resolve("latest-dawn")
    assert cell.config["params"] == latest.config["params"]
    assert (cell.config["z_min"], cell.config["reduced"]) == (6.0, ["z_min"])
    assert cell.chips == 1 and cell.limits
    t = cell.traffic
    assert (t["z_min"], t["z_max"]) == (6.0, 12.0)
    assert t["quantities"] == latest.traffic["quantities"]
    assert t["include_dvdr_in_tau21"] and t["apply_rsds"]


def test_a_chained_cell_from_new_files_alone_resolves(tmp_path):
    """A later change adds a chained cell as files and entries only."""
    bench_dir = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(BENCH_DIR / sub, bench_dir / sub)
    (bench_dir / "traffic" / "late-chain.toml").write_text(
        'loop = "closed"\nz_min = 8.0\nz_max = 10.0\n'
        'quantities = ["brightness_temp"]\ninclude_dvdr_in_tau21 = true\napply_rsds = true\n')
    (bench_dir / "limits" / "late-chain.toml").write_text(
        "[Tb]\nlimit = 1e-4\nlower = 1e-6\nupper = 1e-2\n")
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "late-chain", "config": "latest-256-768-z6",
                               "traffic": "late-chain", "chips": 1, "why": "test"})
    cell = cells.resolve("late-chain", bench, root=BENCH_DIR.parent, bench_dir=bench_dir)

    import py21cmfast_torch as p21

    inputs = cells.build_inputs(p21.InputParameters, cell, SEED)
    band = cells.band_nodes(cell, inputs)
    assert max(inputs.node_redshifts) > 35.0 and min(band) == 8.0
    assert 10.0 <= max(band) < 10.0 * 1.02 + 0.02
    assert len(cells.warmup_inputs(cell, inputs).node_redshifts) == cells.WARMUP_NODES


@pytest.fixture(scope="module")
def traced_run():
    """One traced run of the cell at the tiny box, from an empty recorder."""
    from py21cmfast_torch import tracing

    tracing.reset()
    cell = cells.resolve(WORKLOAD)
    result, lines = loop.run(cell, SEED, 0.0, True, CPU, time.perf_counter(),
                             overrides=TINY[cell.config_name])
    return cell, result, lines


def test_the_tiny_chained_cone_agrees_with_the_reference(traced_run):
    cell, result, lines = traced_run
    import py21cmfast_torch as p21

    inputs = cells.build_inputs(p21.InputParameters, cell, SEED, TINY[cell.config_name])
    assert result["info"]["nodes"] == len(inputs.node_redshifts)
    assert len(cells.band_nodes(cell, inputs)) < len(inputs.node_redshifts)
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["checks"]) == {"ics", "Tb", "density", "Ts", "x_e", "xH", "tau21", "v_z"}
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    assert result["correct"] is True, lines


def test_readers_read_the_traced_chained_run(traced_run):
    """Every metric listed for the cell reads, but those of the card; the
    window is the last `cones` runs of the recorder, so the warm-up cone's
    three nodes are not read."""
    cell, result, _ = traced_run
    listed = {m["name"] for m in cell.per_layer}
    got = set(result["metrics"])
    assert got == listed - CARD_ONLY
    for name, m in result["metrics"].items():
        assert math.isfinite(m["value"]) and m["value"] >= 0, name
    assert result["metrics"]["ionize.radii_per_node"]["value"] > 0
    assert result["metrics"]["ts.sfrd_batched_shells_per_node"]["value"] > 0


def test_per_node_readers_read_the_band_alone(traced_run):
    """The program's books of the band's nodes alone: the dawn nodes above
    the band, which skip the ionization's ladder, are not averaged in."""
    from py21cmfast_torch import tracing

    import py21cmfast_torch as p21

    cell, result, _ = traced_run
    inputs = cells.build_inputs(p21.InputParameters, cell, SEED, TINY[cell.config_name])
    first = len(inputs.node_redshifts) - len(cells.band_nodes(cell, inputs))
    runs = tracing.runs(last=result["attempted"])
    assert first > 0 and all(len(r["nodes"]) == len(inputs.node_redshifts) for r in runs)

    def radii(books):
        return sum(sum(b["counters"].get("ionize.radii", {}).values()) for b in books)

    band = [b for r in runs for b in r["nodes"][first:]]
    scroll = [b for r in runs for b in r["nodes"]]
    read = result["metrics"]["ionize.radii_per_node"]["value"]
    assert read == radii(band) / len(band)
    assert read > radii(scroll) / len(scroll)
